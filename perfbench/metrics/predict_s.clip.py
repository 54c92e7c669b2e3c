"""The "model predict" phase of ``MotionPipeline.run`` (U2Net mask, shape
and video encoding, point decoding, trajectories back on the host), from
the port's own phase timer, mean over the window's clips."""

from perfbench.lib.readers import mean_of


def read(ctx):
    return mean_of(ctx["state"].timers, ("model predict",), ctx)
