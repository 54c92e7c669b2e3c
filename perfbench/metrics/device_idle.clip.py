"""The device's idle share of a clip: 1 - the union of kernel intervals a
traced clip over the wall seconds a clip of the window (profiler off)."""

from perfbench.lib.readers import device_idle


def read(ctx):
    return device_idle(ctx)
