"""K1 (``csrc/flash_fwd.cu``, kernels named ``*k1_flash_fwd*``) in a clip:
the least time of its calls (8 global layers over T x 324 tokens and the
shape encoder) over its device time in the traced clips."""

from perfbench.lib.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
