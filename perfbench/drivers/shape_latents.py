"""The device half of an image -> mesh request, as
``ShapeGenPipeline.__call__`` runs it: the image onto the device,
``encode_cond``, ``denoise`` (the CFG flow-matching Euler loop) and
``vae_decode``, each ending in a synchronise; the request stops before the
volume decode.

Set-up draws the three models' weights on the device, builds the pipeline
from them, makes a pool of seeded images and runs one request. Request i
takes image i mod pool and noise drawn from the run's seed and i. After the
window a sample of the requests, drawn from the seed, is recomputed by the
plain reference and each stage's output held to it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np

from perfbench.lib import flops, inputs, weights
from perfbench.lib.bench import Cell, stream_seed
from perfbench.reference import nets

STAGES = ("encode_cond", "denoise", "vae_decode")


@dataclasses.dataclass
class State:
    cell: Cell
    pipe: object
    images: list
    sigmas: np.ndarray
    outputs: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)    # per request
    labels: bool = False


def model_makers(cfg: dict) -> dict:
    return {
        "conditioner": lambda: nets.DinoViT(
            cfg["cond_dim"], cfg["cond_depth"], cfg["cond_heads"], 14,
            cfg["cond_native_grid"], cfg["cond_mlp_type"]),
        "dit": lambda: nets.DiT(cfg["latent_dim"], cfg["cond_dim"], cfg["dit_hidden"],
                                cfg["dit_heads"], cfg["dit_depth"], cfg["dit_single"]),
        "vae": lambda: nets.ShapeVAE(cfg["latent_dim"], cfg["vae_width"],
                                     cfg["vae_heads"], cfg["vae_layers"]),
    }


def state_dicts(cell: Cell) -> dict:
    import torch
    dtype = getattr(torch, cell.config["dtype"])
    sds = {name: weights.draw(build, stream_seed(cell.seed, 1 + k), cell.device, dtype)
           for k, (name, build) in enumerate(model_makers(cell.config).items())}
    weights.smooth_query_embedding(sds["vae"])
    return sds


def noise(cell: Cell, i: int):
    import torch
    c = cell.config
    gen = torch.Generator(cell.device).manual_seed(stream_seed(cell.seed, 16 + i))
    return torch.randn(1, c["num_latents"], c["latent_dim"], generator=gen,
                       device=cell.device)


def setup(cell: Cell) -> State:
    import torch
    from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
    from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline

    c, p = cell.config, cell.params
    sds = state_dicts(cell)
    pipe = ShapeGenPipeline(
        sds, num_latents=c["num_latents"], latent_dim=c["latent_dim"],
        cond_dim=c["cond_dim"], cond_depth=c["cond_depth"],
        cond_heads=c["cond_heads"], dit_hidden=c["dit_hidden"],
        dit_heads=c["dit_heads"], dit_depth=c["dit_depth"],
        dit_single=c["dit_single"], vae_width=c["vae_width"],
        vae_heads=c["vae_heads"], vae_layers=c["vae_layers"],
        image_size=c["image_size"], dtype=getattr(torch, c["dtype"]),
        cond_mlp_type=c["cond_mlp_type"], cond_native_grid=c["cond_native_grid"],
        device=cell.device)
    del sds
    images = [inputs.synthetic_image(stream_seed(cell.seed, 8 + k), c["image_size"])
              for k in range(p["images"])]
    state = State(cell, pipe, images, flow_match_sigmas(c["steps"]))
    request(state, -1)
    state.outputs.clear()
    state.spans.clear()
    return state


def _sync(cell):
    if cell.device == "cuda":
        import torch
        torch.cuda.synchronize()


def request(state: State, i: int) -> None:
    import torch
    from torch.profiler import record_function
    cell, pipe = state.cell, state.pipe
    span = (lambda name: record_function(name)) if state.labels else \
        (lambda name: contextlib.nullcontext())
    t = [time.perf_counter()]
    with span("encode_cond"):
        cond = pipe.encode_cond(pipe.prepare_image(state.images[i % len(state.images)]))
        pair = torch.cat([cond, torch.zeros_like(cond)])
        _sync(cell)
    t.append(time.perf_counter())
    with span("denoise"):
        latents = pipe.denoise(noise(cell, i), pair, state.sigmas,
                               float(cell.config["guidance"]))
        _sync(cell)
    t.append(time.perf_counter())
    with span("vae_decode"):
        processed = pipe.vae_decode(latents)
        _sync(cell)
    t.append(time.perf_counter())
    state.spans.append(dict(zip(STAGES, np.diff(t))))
    state.outputs.append((i, cond, latents, processed))


@contextlib.contextmanager
def trace_spans(state: State):
    """The harness's own spans around the three stages, as profiler ranges."""
    state.labels = True
    try:
        yield list(STAGES)
    finally:
        state.labels = False


def request_flops(state: State) -> float:
    """Model FLOPs of a request: conditioner, every DiT step at the CFG
    batch of 2, the ShapeVAE decode (``perfbench/lib/flops.py``)."""
    return float(sum(flops.shape_flops(state.cell.config).values()))


def k1_calls(state: State) -> list[tuple]:
    return flops.shape_k1_calls(state.cell.config)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def check(state: State, control: bool = False):
    """Recompute a seeded sample of the window's requests with the plain
    reference and hold each stage's output to it. Returns (the compared
    numbers, the control's readings of them: the reference in fp8 against
    the f32 one, with ``control``, else None)."""
    import torch

    from perfbench.reference.pipelines import ShapeReference
    cell = state.cell
    done = list(state.outputs)
    state.pipe, state.outputs = None, []
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    k = min(cell.params["checked_requests"], len(done))
    pick = np.random.default_rng([abs(cell.seed), 5]).choice(len(done), k, replace=False)
    ref = ShapeReference(cell.config, state_dicts(cell), cell.device)
    names = ("cond", "latents", "processed")
    gaps = {f"{n}_rel_gap": 0.0 for n in names}
    ctl = dict(gaps)
    for j in sorted(pick):
        i, *got = done[j]
        image = state.images[i % len(state.images)]
        want = ref.stages(image, noise(cell, i))
        for n, g in zip(names, got):
            gaps[f"{n}_rel_gap"] = max(gaps[f"{n}_rel_gap"], _rel(g, want[n]))
        if control:
            nets.PRECISION["mode"] = "fp8"
            try:
                low = ref.stages(image, noise(cell, i))
            finally:
                nets.PRECISION["mode"] = "f32"
            for n in names:
                ctl[f"{n}_rel_gap"] = max(ctl[f"{n}_rel_gap"], _rel(low[n], want[n]))
    if not k:
        gaps = {n: float("inf") for n in gaps}
    lim = cell.spec["limits"]
    out = [(n, v, lim[n]) for n, v in gaps.items()]
    return out, ([(n, v, lim[n]) for n, v in ctl.items()] if control else None)
