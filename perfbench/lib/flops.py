"""Operations of one request, counted from the shapes.

:func:`clip_flops` and :func:`shape_flops` run the plain reference on the
``meta`` device (no storage, no arithmetic) under PyTorch's
``FlopCounterMode``, which counts 2 m n k for every matrix product and
convolution at the request's own shapes: the model FLOPs of one request.
:func:`clip_k1_calls` and :func:`shape_k1_calls` list the attention calls
that run on K1, the flash forward, in one request: the work that
``attn_roofline`` sets against K1's device time.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import nets


def _count(fn) -> int:
    with torch.device("meta"), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def clip_flops(cfg: dict, frames: int, size: int, vertices: int) -> dict:
    """{"u2net", "motion"}: FLOPs of the U2Net over ``frames`` frames of
    ``size``^2 and of the motion model (shape encoding of the samples, video
    encoding, decoding ``vertices`` points in every frame)."""
    def u2net():
        nets.U2Net()(torch.empty(frames, size, size, 3))

    def motion():
        m = nets.MotionModel(cfg)
        p = lambda n: torch.empty(1, n, 3)
        s = cfg["num_shape_samples"]
        feat = m.encode_shape(p(s), p(s), p(s))
        tok = m.encode_video(torch.empty(frames, size, size, 3), feat, cfg["frames"])
        m.decode_points(tok, p(vertices), p(vertices), p(vertices))
    return {"u2net": _count(u2net), "motion": _count(motion)}


def shape_flops(cfg: dict) -> dict:
    """{"conditioner", "denoise", "vae_decode"}: FLOPs of one request (the
    DiT at batch 2, the classifier-free-guidance pair, at every step)."""
    s, g = cfg["image_size"], cfg["image_size"] // 14
    lc = g * g

    def cond():
        nets.DinoViT(cfg["cond_dim"], cfg["cond_depth"], cfg["cond_heads"], 14,
                     cfg["cond_native_grid"], cfg["cond_mlp_type"])(
            torch.empty(1, s, s, 3))

    def denoise():
        dit = nets.DiT(cfg["latent_dim"], cfg["cond_dim"], cfg["dit_hidden"],
                       cfg["dit_heads"], cfg["dit_depth"], cfg["dit_single"])
        x = torch.empty(2, cfg["num_latents"], cfg["latent_dim"])
        c = torch.empty(2, lc, cfg["cond_dim"])
        dit(x, torch.empty(2), c)

    def vae():
        nets.ShapeVAE(cfg["latent_dim"], cfg["vae_width"], cfg["vae_heads"],
                      cfg["vae_layers"]).decode(
            torch.empty(1, cfg["num_latents"], cfg["latent_dim"]))
    return {"conditioner": _count(cond), "denoise": _count(denoise) * cfg["steps"],
            "vae_decode": _count(vae)}


def clip_k1_calls(cfg: dict, frames: int) -> list[tuple]:
    """(count, b, h, sq, sk, head_dim) of each K1 call site in a clip: the 8
    global layers over every token of the window and the shape encoder's 64
    queries over the samples."""
    g = cfg["image_size"] // cfg["patch_size"]
    tokens = frames * (4 + cfg["tokens"] + g * g)
    h = cfg["feat_dim"] // cfg["head_dim"]
    return [(cfg["n_alternating_layers"] // 2, 1, h, tokens, tokens, cfg["head_dim"]),
            (1, 1, h, cfg["tokens"], cfg["num_shape_samples"], cfg["head_dim"])]


def shape_k1_calls(cfg: dict) -> list[tuple]:
    """(count, b, h, sq, sk, head_dim) of each K1 call site in a shape
    request: the conditioner's layers over CLS + patches, every DiT block
    of every step over the joint [condition | latent] tokens at the CFG
    batch of 2, and the ShapeVAE's self-attention over the latents (K1
    only above 1 024 latents: the dispatcher's K2 or K6 below)."""
    g = cfg["image_size"] // 14
    cond = 1 + g * g
    joint = g * g + cfg["num_latents"]
    calls = [(cfg["cond_depth"], 1, cfg["cond_heads"], cond, cond,
              cfg["cond_dim"] // cfg["cond_heads"]),
             ((cfg["dit_depth"] + cfg["dit_single"]) * cfg["steps"], 2,
              cfg["dit_heads"], joint, joint, cfg["dit_hidden"] // cfg["dit_heads"])]
    if cfg["num_latents"] > 1024:
        calls.append((cfg["vae_layers"], 1, cfg["vae_heads"], cfg["num_latents"],
                      cfg["num_latents"], cfg["vae_width"] // cfg["vae_heads"]))
    return calls
