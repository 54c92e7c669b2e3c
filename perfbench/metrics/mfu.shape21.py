"""A request's model FLOPs (DINOv2-large, 50 steps of the 2.1 DiT at batch
2 with two routed experts and the shared one a token, the ShapeVAE decode,
counted from the shapes) over its wall seconds in the window, as a share of
the bf16 peak."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
