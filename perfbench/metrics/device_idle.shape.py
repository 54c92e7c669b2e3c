"""The device's idle share of a request: 1 - the union of kernel intervals
a traced request over the wall seconds a request of the window (profiler
off)."""

from perfbench.lib.readers import device_idle


def read(ctx):
    return device_idle(ctx)
