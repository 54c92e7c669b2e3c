"""A clip's model FLOPs (U2Net and motion model, counted from the shapes)
over its wall seconds in the window, as a share of the bf16 peak."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
