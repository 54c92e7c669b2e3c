"""Seeded weights, drawn on the device in a few large calls.

Every leaf of a model (its name and shape taken from the plain reference's
module, built without storage) gets its init rule; the leaves of one rule
share one draw from a ``torch.Generator`` on the device, in the dtype they
are served in, and are views of it scaled in place. The same seed gives
the same bits, so the reference draws the weights again after the system
under test is freed.

Rules (the system's own seeded init, ``init_weights``, and the settings of
its smoke run, with every bias and norm scale drawn too, so that a program
that drops a bias or a norm's affine terms computes something else):
matrices and convolution kernels lecun-normal (N(0, 1) / sqrt(fan_in));
biases N(0, 0.1); norm scales (every other 1-D leaf) U(0.5, 1.5); the CLS
token 0; learnable and special tokens N(0, 1); DINOv2's position table
N(0, 0.02); LayerScale gammas U(0.1, 1) (a trained ViT's LayerScale sits far
above its 1e-5 init, which would mute every DINOv2 branch). The U2Net takes
torch's default convolution init (U(-1, 1) / sqrt(fan_in), bias alike),
BatchNorm scales U(0.5, 1.5) and shifts U(-0.1, 0.1) over default running
statistics, and its ``outconv`` calibrated so that the fused logit over a
few frames of the clip has median 0 and standard deviation 4.
"""

from __future__ import annotations

import math

import torch


def _rule(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("learnable_tokens", "special_token_0", "special_token_rest"):
        return "normal"
    if leaf == "pos_embed":
        return "pos"
    if leaf == "cls_token":
        return "zero"
    if leaf == "bias":
        return "bias"
    if leaf == "gamma":
        return "gamma"
    if len(shape) == 1:
        return "scale"
    return "lecun"


def _meta_shapes(build):
    with torch.device("meta"):
        module = build()
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def draw(build, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A state dict for the module ``build()`` makes, by the rules above."""
    leaves = _meta_shapes(build)
    gen = torch.Generator(device).manual_seed(seed)
    rules = [(n, s, _rule(n, s)) for n, s in leaves]
    size = lambda s: math.prod(s)
    normals = ("normal", "pos", "lecun", "bias")
    n_normal = sum(size(s) for _, s, r in rules if r in normals)
    n_uniform = sum(size(s) for _, s, r in rules if r in ("gamma", "scale"))
    normal = torch.randn(n_normal, generator=gen, device=device, dtype=dtype)
    uniform = torch.rand(n_uniform, generator=gen, device=device, dtype=dtype)
    out, on, ou = {}, 0, 0
    with torch.no_grad():
        for name, shape, rule in rules:
            n = size(shape)
            if rule in normals:
                t = normal[on:on + n].view(shape)
                on += n
                if rule == "pos":
                    t.mul_(0.02)
                elif rule == "bias":
                    t.mul_(0.1)
                elif rule == "lecun":
                    t.mul_(1.0 / math.sqrt(size(shape[1:])))
            elif rule in ("gamma", "scale"):
                t = uniform[ou:ou + n].view(shape)
                ou += n
                if rule == "gamma":
                    t.mul_(0.9).add_(0.1)
                else:
                    t.add_(0.5)
            else:
                t = torch.zeros(shape, device=device, dtype=dtype)
            out[name] = t
    return out


def smooth_query_embedding(vae_sd: dict, num_freqs: int = 8) -> None:
    """Keep only the lowest octave of the ShapeVAE's query embedding (the
    smoke's setting; the benchmarked request stops before the volume
    query, so this changes no number compared)."""
    w = vae_sd["geo_decoder.query_proj.weight"]
    with torch.no_grad():
        for part in range(2):
            for axis in range(3):
                start = 3 + (part * 3 + axis) * num_freqs
                w[:, start + 1:start + num_freqs] = 0


def u2net(seed: int, device, frames, dtype=torch.bfloat16) -> dict:
    """The full-width U2Net's state dict, ``outconv`` calibrated on
    ``frames`` ((n, H, W, 3) float in [0, 1] on ``device``) through the
    plain reference in float32."""
    from perfbench.reference import nets
    from perfbench.reference.pipelines import exact_matmul, load
    with torch.device("meta"):
        net = nets.U2Net()
    params = [(n, tuple(p.shape)) for n, p in net.named_parameters()]
    gen = torch.Generator(device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in params)
    u = torch.rand(total, generator=gen, device=device, dtype=dtype)
    sd, o = {}, 0
    shapes = dict(params)
    with torch.no_grad():
        for name, shape in params:
            n = math.prod(shape)
            t = u[o:o + n].view(shape)
            o += n
            if name.split(".")[-2].startswith("bn"):
                sd[name] = (t.add_(0.5) if name.endswith("weight")
                            else t.mul_(0.2).sub_(0.1))
                continue
            w_shape = shapes[name.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / math.sqrt(math.prod(w_shape[1:]))
            sd[name] = t.mul_(2.0).sub_(1.0).mul_(bound)
        for name, buf in net.named_buffers():
            if name in sd:
                continue
            leaf = name.rsplit(".", 1)[-1]
            fill = {"weight": 1.0, "running_var": 1.0}.get(leaf, 0.0)
            sd[name] = torch.full(buf.shape, fill, device=device,
                                  dtype=torch.long if leaf == "num_batches_tracked"
                                  else dtype)
        with exact_matmul():
            logit = load(nets.U2Net, sd, device)(frames.float()).float()
        med, k = logit.median(), 4.0 / logit.std()
        sd["outconv.weight"] = (sd["outconv.weight"].float() * k).to(dtype)
        sd["outconv.bias"] = ((sd["outconv.bias"].float() - med) * k).to(dtype)
    return sd
