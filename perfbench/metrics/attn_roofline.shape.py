"""K1 (kernels named ``*k1_flash_fwd*``) in a request: the least time of
its calls (40 conditioner layers over 1 370 tokens, 48 DiT blocks a step
over 4 441 joint tokens at batch 2) over its device time in the traced
request."""

from perfbench.lib.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
