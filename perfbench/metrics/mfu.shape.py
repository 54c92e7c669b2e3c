"""A request's model FLOPs (conditioner, 50 DiT steps at batch 2, ShapeVAE
decode, counted from the shapes) over its wall seconds in the window, as a
share of the bf16 peak."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
