"""The GLB export of a clip (the port's ``glb export`` phase span, whose
children are ``export.glb.texture`` / ``.targets`` / ``.write``): host
seconds, mean over the window's clips."""

from perfbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "motion.run", ("glb export",), device=False)
