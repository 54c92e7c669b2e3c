"""K1 at head dim 128 (kernels named ``*k1_flash_fwd_d128*``) in a request:
the least time of its calls (21 DiT blocks a step, self-attention over
4 097 tokens and cross-attention to 1 370, at batch 2) over its device time
in the traced request."""

from perfbench.lib.shape21 import attn_roofline


def read(ctx):
    return attn_roofline(ctx)
