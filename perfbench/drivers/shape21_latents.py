"""The device half of a Hunyuan3D-2.1 image -> mesh request, as
``ShapeGenPipeline(model="2.1")`` runs it: the image onto the device,
``encode_cond`` (DINOv2-large, ``[CLS | patch]`` tokens), ``denoise`` (the
CFG flow-matching Euler loop of the 2.1 DiT) and ``vae_decode``, each
ending in a synchronise; the request stops before the volume decode.

It is the 2.0 cell's driver (``shape_latents``) with the 2.1 models: the
same request, noise, images and spans, the weights drawn from the 2.1
reference's modules (``perfbench/reference/hunyuan21.py``), and the check
against that reference. The check also recomputes, before the program is
freed, the DiT's first velocity of each checked request (the conditional
half), held to the reference's as ``step1_rel_gap``: compared where the
cell's limits name it, else printed.
"""

from __future__ import annotations

import gc

import numpy as np

# request and trace_spans as the 2.0 cell's: the harness calls them here
from perfbench.drivers.shape_latents import (State, _rel, noise, request,  # noqa: F401
                                             trace_spans)
from perfbench.lib import inputs, shape21, weights
from perfbench.lib.bench import Cell, note, stream_seed
from perfbench.reference import hunyuan21, nets


def state_dicts(cell: Cell) -> dict:
    import torch
    dtype = getattr(torch, cell.config["dtype"])
    makers = hunyuan21.model_makers(cell.config)
    sds = {name: weights.draw(build, stream_seed(cell.seed, 1 + k), cell.device, dtype)
           for k, (name, build) in enumerate(makers.items())}
    weights.smooth_query_embedding(sds["vae"])
    return sds


def setup(cell: Cell) -> State:
    import torch
    from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
    from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline

    c, p = cell.config, cell.params
    sds = state_dicts(cell)
    pipe = ShapeGenPipeline(
        sds, model="2.1", num_latents=c["num_latents"], latent_dim=c["latent_dim"],
        cond_dim=c["cond_dim"], cond_depth=c["cond_depth"],
        cond_heads=c["cond_heads"], cond_mlp_type=c["cond_mlp_type"],
        cond_native_grid=c["cond_native_grid"], dit_hidden=c["dit_hidden"],
        dit_heads=c["dit_heads"], dit_depth=c["dit_depth"],
        dit_moe_layers=c["dit_moe_layers"], dit_experts=c["dit_experts"],
        vae_width=c["vae_width"],
        vae_heads=c["vae_heads"], vae_layers=c["vae_layers"],
        image_size=c["image_size"], dtype=getattr(torch, c["dtype"]),
        device=cell.device)
    del sds
    images = [inputs.synthetic_image(stream_seed(cell.seed, 8 + k), c["image_size"])
              for k in range(p["images"])]
    state = State(cell, pipe, images, flow_match_sigmas(c["steps"]))
    request(state, -1)
    state.outputs.clear()
    state.spans.clear()
    return state


def request_flops(state: State) -> float:
    """Model FLOPs of a request: conditioner, every DiT step at the CFG
    batch of 2 (the mixture of experts at its two routed FFNs and the
    shared one a token), the ShapeVAE decode."""
    return float(sum(shape21.request_flops(state.cell.config).values()))


def k1_calls(state: State) -> list[tuple]:
    return shape21.k1_d128_calls(state.cell.config)


def _first_velocity(pipe, cell: Cell, i: int, cond, sigma: float):
    """The program's DiT velocity of the conditional half at the first
    step of request i."""
    import torch
    with torch.inference_mode():
        x = noise(cell, i)
        pair = torch.cat([cond, torch.zeros_like(cond)])
        t = torch.full((2,), sigma, device=cell.device)
        return pipe.dit(torch.cat([x, x]), t, pair).chunk(2)[0].clone()


def check(state: State, control: bool = False):
    """Recompute a seeded sample of the window's requests with the plain
    reference and hold each stage's output, and the DiT's first velocity,
    to it. Returns (the compared numbers: those the cell's limits name,
    the control's readings of them with ``control``, else None)."""
    import torch
    from motion324_tpu_torch.utils import profiling

    cell = state.cell
    if cell.device == "cuda":
        note(f"rows per routed expert, set-up to here: "
             f"{profiling.counters().get('shape.dit.moe.rows')}")
    done = list(state.outputs)
    k = min(cell.params["checked_requests"], len(done))
    pick = sorted(np.random.default_rng([abs(cell.seed), 5]).choice(len(done), k,
                                                                     replace=False))
    sigma = float(state.sigmas[0])
    step1 = {j: _first_velocity(state.pipe, cell, done[j][0], done[j][1], sigma)
             for j in pick}
    state.pipe, state.outputs = None, []
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    ref = hunyuan21.Shape21Reference(cell.config, state_dicts(cell), cell.device)
    names = ("cond", "step1", "latents", "processed")
    gaps = {f"{n}_rel_gap": 0.0 for n in names}
    ctl = dict(gaps)
    for j in pick:
        i, cond, latents, processed = done[j]
        got = dict(cond=cond, step1=step1[j], latents=latents, processed=processed)
        image = state.images[i % len(state.images)]
        want = ref.stages(image, noise(cell, i))
        for n in names:
            gaps[f"{n}_rel_gap"] = max(gaps[f"{n}_rel_gap"], _rel(got[n], want[n]))
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
    for n, v in gaps.items():
        if n not in lim:
            note(f"not compared {n}: {v!r}"
                 + (f" (control {ctl[n]!r})" if control else ""))
    out = [(n, v, lim[n]) for n, v in gaps.items() if n in lim]
    return out, ([(n, v, lim[n]) for n, v in ctl.items() if n in lim]
                 if control else None)
