"""``ShapeGenPipeline.denoise`` (50 CFG flow-matching steps of the DiT):
the harness's span around the call, ending in a synchronise, mean over
the window's requests."""

from perfbench.lib.readers import mean_of


def read(ctx):
    return mean_of(ctx["state"].spans, ("denoise",), ctx)
