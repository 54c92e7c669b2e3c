"""CLIP image-similarity and DreamSim perceptual-distance metrics, as
``nn.Module`` towers (counterpart of ``motion324_tpu/evaluation/clip_sim.py``).

- :class:`CLIPVisionTower`: a pre-norm CLIP vision transformer returning
  the projected CLS embedding, laid out as HF's
  ``CLIPVisionModelWithProjection`` (``vision_model.embeddings...``,
  ``vision_model.encoder.layers.{i}.self_attn.q_proj``, ``visual_projection``),
  so :func:`convert_clip_vision` takes such a state dict nearly as it is;
- :class:`DINOTower`: DINO-v1's ViT in facebookresearch/dino's layout
  (``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``norm``), loaded by
  :func:`convert_dino_vit`;
- :func:`clip_similarity` (mean per-frame cosine similarity) and
  :class:`DreamSim` (an ensemble of towers, L2-normalised embeddings
  concatenated, ``1 - cos``).

The JAX towers compute attention as a plain ``einsum`` and softmax, and
CLIP-bigG's heads are 104 wide, so these do the same in plain PyTorch: no
kernel of the port runs here. Without weights every tower is seeded and
random: a deterministic, relative-only measure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.evaluation.video_metrics import (resize_frames,
                                                          seeded_init)

__all__ = ["CLIPVisionTower", "CLIPVisionCfg", "convert_clip_vision",
           "DINOTower", "DINOCfg", "convert_dino_vit",
           "clip_similarity", "DreamSim"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionCfg:
    """Defaults follow OpenCLIP ViT-bigG-14 (the similarity backbone)."""

    hidden: int = 1664
    intermediate: int = 8192
    layers: int = 48
    heads: int = 16
    image_size: int = 224
    patch: int = 14
    proj_dim: int = 1280
    quick_gelu: bool = False  # bigG uses plain gelu; HF CLIP uses quick_gelu


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """Plain softmax attention over ``(B, L, D)`` projections."""
    b, n, d = q.shape
    hd = d // heads
    split = lambda x: x.reshape(b, n, heads, hd).transpose(1, 2)
    a = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / math.sqrt(hd)
    o = torch.einsum("bhqk,bhkd->bhqd", a.softmax(-1), split(v))
    return o.transpose(1, 2).reshape(b, n, d)


class _Module(nn.Module):
    """A holder of named children (HF's nesting)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class _CLIPLayer(nn.Module):
    def __init__(self, c: CLIPVisionCfg):
        super().__init__()
        self.heads, self.quick_gelu = c.heads, c.quick_gelu
        self.layer_norm1 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.self_attn = _Module(**{n: nn.Linear(c.hidden, c.hidden) for n in
                                    ("q_proj", "k_proj", "v_proj", "out_proj")})
        self.layer_norm2 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.mlp = _Module(fc1=nn.Linear(c.hidden, c.intermediate),
                           fc2=nn.Linear(c.intermediate, c.hidden))

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(_attention(a.q_proj(h), a.k_proj(h), a.v_proj(h),
                                      self.heads))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp.fc2(h)


class CLIPVisionTower(nn.Module):
    """Pre-norm CLIP vision transformer returning the projected CLS embed.
    ``state_dict``: HF ``CLIPVisionModel(WithProjection)`` weights (through
    :func:`convert_clip_vision`); without them, seeded random weights."""

    MEAN = (0.48145466, 0.4578275, 0.40821073)
    STD = (0.26862954, 0.26130258, 0.27577711)

    def __init__(self, cfg: CLIPVisionCfg = CLIPVisionCfg(),
                 state_dict: dict | None = None, seed: int = 0):
        super().__init__()
        self.cfg = c = cfg
        n_tok = (c.image_size // c.patch) ** 2 + 1
        self.vision_model = _Module(
            embeddings=_Module(
                patch_embedding=nn.Conv2d(3, c.hidden, c.patch, c.patch,
                                          bias=False),
                position_embedding=nn.Embedding(n_tok, c.hidden)),
            pre_layrnorm=nn.LayerNorm(c.hidden, eps=1e-5),
            encoder=_Module(layers=nn.ModuleList(
                _CLIPLayer(c) for _ in range(c.layers))),
            post_layernorm=nn.LayerNorm(c.hidden, eps=1e-5))
        self.vision_model.embeddings.class_embedding = nn.Parameter(
            torch.zeros(c.hidden))
        self.visual_projection = nn.Linear(c.hidden, c.proj_dim, bias=False)
        self.register_buffer("mean", torch.tensor(self.MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(self.STD), persistent=False)
        if state_dict is None:
            seeded_init(self, seed)
        else:
            self.load_state_dict(convert_clip_vision(state_dict, cfg))
        self.eval()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` normalised pixels -> ``(B, proj_dim)``."""
        vm, emb = self.vision_model, self.vision_model.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2)
        x = x.transpose(1, 2)
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))

    @torch.no_grad()
    def embed(self, images: np.ndarray) -> np.ndarray:
        """``(B, H, W, 3)`` in [0, 1] -> ``(B, proj_dim)`` (CLIP's input
        normalisation), on the tower's device."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.mean.device)
        return self((x - self.mean) / self.std).cpu().numpy()


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v.detach().cpu().numpy() if hasattr(v, "detach")
                           else np.asarray(v), dtype=torch.float32)


def convert_clip_vision(state_dict: dict, cfg: CLIPVisionCfg) -> dict:
    """HF torch ``CLIPVisionModel(WithProjection)`` state dict -> the
    tower's: the same names, in float32; without ``visual_projection`` (a
    vision tower alone) the identity-like ``eye(proj_dim, hidden)``."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("vision_model.") or k == "visual_projection.weight":
            if not k.endswith("position_ids"):
                out[k] = _f32(v)
    out.setdefault("visual_projection.weight",
                   torch.eye(cfg.proj_dim, cfg.hidden))
    return out


@dataclasses.dataclass(frozen=True)
class DINOCfg:
    """Defaults follow DINO ViT-B/16, the first DreamSim backbone."""

    hidden: int = 768
    intermediate: int = 3072
    layers: int = 12
    heads: int = 12
    image_size: int = 224
    patch: int = 16


class _DINOBlock(nn.Module):
    def __init__(self, c: DINOCfg):
        super().__init__()
        self.heads = c.heads
        self.norm1 = nn.LayerNorm(c.hidden, eps=1e-6)
        self.attn = _Module(qkv=nn.Linear(c.hidden, 3 * c.hidden),
                            proj=nn.Linear(c.hidden, c.hidden))
        self.norm2 = nn.LayerNorm(c.hidden, eps=1e-6)
        self.mlp = _Module(fc1=nn.Linear(c.hidden, c.intermediate),
                           fc2=nn.Linear(c.intermediate, c.hidden))

    def forward(self, x):
        q, k, v = self.attn.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.attn.proj(_attention(q, k, v, self.heads))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class DINOTower(nn.Module):
    """DINO-v1 ViT (no pre-norm, fused qkv, no LayerScale) returning the
    final-LayerNorm CLS token, in facebookresearch/dino's layout:
    ``state_dict`` (a dino ``VisionTransformer``'s, or DreamSim's
    LoRA-merged one) loads through :func:`convert_dino_vit`."""

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self, cfg: DINOCfg = DINOCfg(), state_dict: dict | None = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = c = cfg
        n_tok = (c.image_size // c.patch) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, c.hidden))
        self.patch_embed = _Module(proj=nn.Conv2d(3, c.hidden, c.patch, c.patch))
        self.blocks = nn.ModuleList(_DINOBlock(c) for _ in range(c.layers))
        self.norm = nn.LayerNorm(c.hidden, eps=1e-6)
        self.register_buffer("mean", torch.tensor(self.MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(self.STD), persistent=False)
        if state_dict is None:
            seeded_init(self, seed)
        else:
            self.load_state_dict(convert_dino_vit(state_dict, cfg))
        self.eval()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` normalised pixels -> ``(B, hidden)``."""
        x = self.patch_embed.proj(pixels.permute(0, 3, 1, 2)).flatten(2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1),
                       x.transpose(1, 2)], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x[:, 0])

    embed = CLIPVisionTower.embed


def convert_dino_vit(state_dict: dict, cfg: DINOCfg = DINOCfg()) -> dict:
    """facebookresearch/dino ``VisionTransformer`` state dict -> the
    tower's: the same names in float32, ``cls_token`` and ``pos_embed``
    with their leading singleton axes (any head is dropped)."""
    keep = ("cls_token", "pos_embed", "patch_embed.", "blocks.", "norm.")
    out = {k: _f32(v) for k, v in state_dict.items() if k.startswith(keep)}
    out["cls_token"] = out["cls_token"].reshape(1, 1, cfg.hidden)
    out["pos_embed"] = out["pos_embed"].reshape(1, -1, cfg.hidden)
    return out


def _unit(e: np.ndarray) -> np.ndarray:
    return e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-10)


def clip_similarity(video1: np.ndarray, video2: np.ndarray,
                    tower: CLIPVisionTower | None = None,
                    batch: int = 8, device=None) -> float:
    """Mean per-frame CLIP cosine similarity between two aligned videos;
    without ``tower`` a seeded bigG-14 on ``device`` (default CUDA)."""
    tower = tower or CLIPVisionTower().to(resolve_device(device))
    t = min(len(video1), len(video2))
    sims = []
    for i in range(0, t, batch):
        a = resize_frames(video1[i:i + batch], tower.cfg.image_size)
        b = resize_frames(video2[i:i + batch], tower.cfg.image_size)
        sims.extend(np.sum(_unit(tower.embed(a)) * _unit(tower.embed(b)),
                           axis=-1).tolist())
    return float(np.mean(sims[:t]))


class DreamSim(nn.Module):
    """DreamSim perceptual distance: an ensemble of ViT towers.

    The public model concatenates L2-normalised embeddings of DINO-B/16,
    CLIP-B/32 and OpenCLIP-B/32 and scores ``1 - cos``;
    :meth:`real_ensemble` builds those three at full width. The default
    (no towers) is three compact seeded CLIP towers for fast relative-only
    runs.
    """

    # DreamSim's CLIP backbones embed without the projection head: it
    # converts to the identity when absent from the state dict
    CLIP_B32 = CLIPVisionCfg(hidden=768, intermediate=3072, layers=12,
                             heads=12, image_size=224, patch=32, proj_dim=768,
                             quick_gelu=True)
    OPEN_CLIP_B32 = dataclasses.replace(CLIP_B32, quick_gelu=False)
    SMALL = CLIPVisionCfg(hidden=128, intermediate=256, layers=2, heads=4,
                          image_size=224, patch=32, proj_dim=128)

    def __init__(self, towers: Sequence[nn.Module] | None = None):
        super().__init__()
        if towers is None:
            towers = [CLIPVisionTower(self.SMALL, seed=s) for s in range(3)]
        self.towers = nn.ModuleList(towers)

    @classmethod
    def real_ensemble(cls, dino_state_dict=None, clip_state_dict=None,
                      open_clip_state_dict=None) -> "DreamSim":
        """The released DreamSim backbones at full width (seeded random
        ones where no state dict is given)."""
        return cls([DINOTower(DINOCfg(), state_dict=dino_state_dict),
                    CLIPVisionTower(cls.CLIP_B32, state_dict=clip_state_dict,
                                    seed=1),
                    CLIPVisionTower(cls.OPEN_CLIP_B32,
                                    state_dict=open_clip_state_dict, seed=2)])

    @classmethod
    def from_state_dicts(cls, specs: Sequence[dict]) -> "DreamSim":
        """Towers from ``{"kind": "dino" | "clip", "cfg": {...fields...},
        "state_dict": ...}`` specs."""
        towers = []
        for s in specs:
            if s["kind"] == "dino":
                towers.append(DINOTower(DINOCfg(**s.get("cfg", {})),
                                        state_dict=s["state_dict"]))
            else:
                towers.append(CLIPVisionTower(CLIPVisionCfg(**s.get("cfg", {})),
                                              state_dict=s["state_dict"]))
        return cls(towers)

    def embed(self, images: np.ndarray) -> np.ndarray:
        return _unit(np.concatenate(
            [_unit(tw.embed(resize_frames(images, tw.cfg.image_size)))
             for tw in self.towers], axis=-1))

    def forward(self, video1: np.ndarray, video2: np.ndarray) -> float:
        """Mean per-frame DreamSim distance between two aligned videos."""
        t = min(len(video1), len(video2))
        e1 = self.embed(np.asarray(video1[:t]))
        e2 = self.embed(np.asarray(video2[:t]))
        return float(np.mean(1.0 - np.sum(e1 * e2, axis=-1)))
