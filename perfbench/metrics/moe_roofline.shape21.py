"""The expert FFNs' grouped GEMMs in a request: their least time (every
token's two routed FFNs and the shared one at 989 TFLOP/s, or the experts'
weights and the rows read and written once at 3.35 TB/s) over the device
time of the grouped-GEMM kernels in the traced request."""

from perfbench.lib.shape21 import moe_roofline


def read(ctx):
    return moe_roofline(ctx)
