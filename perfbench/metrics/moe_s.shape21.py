"""The mixture of experts of the 2.1 DiT's last six blocks (router,
grouping, the grouped GEMMs of the routed and shared experts, the combine):
device seconds of the port's ``shape.dit.moe`` spans a step, mean over the
window's requests."""

from perfbench.lib.shape21 import moe_s


def read(ctx):
    return moe_s(ctx)
