"""The point decoder of a clip (``predict.decode_points``, every chunk) and
the trajectories back on the host (``predict.to_host``): the port's spans,
device seconds summed a clip, mean over the window's clips."""

from perfbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "motion.run",
                       ("predict.decode_points", "predict.to_host"))
