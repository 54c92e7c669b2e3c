"""The encoders of a clip (``predict.encode_shape``: the mesh tokens;
``predict.encode_video``: DINOv2 and the local/global pairs, K1 and K2):
the port's spans, device seconds summed a clip, mean over the window's
clips."""

from perfbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "motion.run",
                       ("predict.encode_shape", "predict.encode_video"))
