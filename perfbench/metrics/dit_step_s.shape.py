"""One CFG Euler step of the DiT at batch 2 (``shape.denoise.step`` in
``ShapeGenPipeline.denoise``): the port's span, device seconds, mean over
the window's steps."""

from perfbench.lib.spans import per_span


def read(ctx):
    return per_span(ctx, "shape.denoise", "shape.denoise.step")
