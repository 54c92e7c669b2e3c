"""The U2Net mask of a clip (``predict.segment`` in ``MotionPipeline._mask``):
the port's span, device seconds summed a clip, mean over the window's
clips."""

from perfbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "motion.run", ("predict.segment",))
