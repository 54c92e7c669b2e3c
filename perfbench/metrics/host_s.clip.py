"""Host stages of a clip in ``MotionPipeline.run``: video decode, mesh load
and sampling, smoothing and GLB export, from the port's own phase timers
(``MOTION324_DEBUG=1``), mean over the window's clips."""

from perfbench.lib.readers import mean_of

PHASES = ("video decode", "mesh load+sample", "smoothing", "glb export")


def read(ctx):
    return mean_of(ctx["state"].timers, PHASES, ctx)
