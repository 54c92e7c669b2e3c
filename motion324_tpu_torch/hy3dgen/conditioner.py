"""Shape-generation image conditioners: single-view, multiview, and dual.

- :class:`DinoConditioner`: a frozen DINOv2 ViT returning ``[CLS | patch]``
  tokens;
- :class:`DinoConditionerMV`: each of up to ``view_num`` views encoded by the
  same ViT (views folded into the batch for one forward), a fixed 1-D sincos
  VIEW embedding of the view's canonical slot (front/left/back/right) added
  to every token of that view, and the views' tokens concatenated;
- :class:`SingleImageEncoder` / :class:`DualImageEncoder`: wrappers returning
  ``{'main': ...}`` / ``{'main': ..., 'additional': ...}``. The DiT consumes
  ``main``; ``additional`` serves the legacy dual-guidance CFG.

The unconditional embedding is zeros of the conditional shape in every
variant (``torch.zeros_like``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from motion324_tpu_torch.models.dinov2 import DinoViT

__all__ = ["get_1d_sincos_pos_embed", "DinoConditioner", "DinoConditionerMV",
           "SingleImageEncoder", "DualImageEncoder", "VIEW_SLOTS"]

# canonical multiview slot order
VIEW_SLOTS = {"front": 0, "left": 1, "back": 2, "right": 3}


def get_1d_sincos_pos_embed(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """``pos`` (M,) -> (M, embed_dim): first half sin, second half cos of
    ``pos / 10000^(2i/d)``, in float64."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _dino(embed_dim, depth, num_heads, patch_size, native_grid, mlp_type,
          attn_backend) -> DinoViT:
    return DinoViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                   patch_size=patch_size, native_grid=native_grid,
                   mlp_type=mlp_type, keep_cls=True, attn_backend=attn_backend)


class DinoConditioner(nn.Module):
    """Frozen DINOv2 conditioner: ``(B, H, W, 3)`` in [0, 1] ->
    ``(B, 1 + (H/14)(W/14), C)`` [CLS | patch] tokens."""

    def __init__(self, embed_dim: int = 1536, depth: int = 24,
                 num_heads: int = 24, patch_size: int = 14,
                 native_grid: int = 37, mlp_type: str = "swiglu",
                 attn_backend: str | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dino = _dino(embed_dim, depth, num_heads, patch_size, native_grid,
                          mlp_type, attn_backend)

    def forward(self, images):
        return self.dino(images)


class DinoConditionerMV(nn.Module):
    """Multiview DINOv2 conditioner with per-view 1-D sincos embeddings."""

    def __init__(self, embed_dim: int = 1536, depth: int = 24,
                 num_heads: int = 24, patch_size: int = 14,
                 native_grid: int = 37, mlp_type: str = "swiglu",
                 view_num: int = 4, attn_backend: str | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.view_num = view_num
        self.dino = _dino(embed_dim, depth, num_heads, patch_size, native_grid,
                          mlp_type, attn_backend)

    def forward(self, images, view_idxs=None):
        """images (B, V, H, W, 3) in [0, 1]; ``view_idxs`` (B, V) canonical
        slots (default 0..V-1). Returns (B, V*(1+P), C)."""
        b, v, h, w, c = images.shape
        tokens = self.dino(images.reshape(b * v, h, w, c))
        p = tokens.shape[1]
        tokens = tokens.reshape(b, v, p, self.embed_dim)
        if view_idxs is None:
            view_idxs = torch.arange(v, device=images.device).expand(b, v)
        table = torch.as_tensor(get_1d_sincos_pos_embed(
            self.embed_dim, np.arange(self.view_num, dtype=np.float32)),
            dtype=tokens.dtype, device=tokens.device)   # (view_num, C)
        view_emb = table[view_idxs.long()]
        tokens = tokens + view_emb[:, :, None, :]
        return tokens.reshape(b, v * p, self.embed_dim)


class SingleImageEncoder(nn.Module):
    """``{'main': encoder(...)}``."""

    def __init__(self, main_image_encoder: nn.Module):
        super().__init__()
        self.main = main_image_encoder

    def forward(self, images, **kw):
        return {"main": self.main(images, **kw)}

    @staticmethod
    def unconditional(cond: dict) -> dict:
        return {"main": torch.zeros_like(cond["main"])}


class DualImageEncoder(nn.Module):
    """``{'main', 'additional'}``: ``main`` feeds the DiT; ``additional``
    supports the legacy dual-guidance CFG."""

    def __init__(self, main_image_encoder: nn.Module,
                 additional_image_encoder: nn.Module):
        super().__init__()
        self.main = main_image_encoder
        self.additional = additional_image_encoder

    def forward(self, images, **kw):
        return {"main": self.main(images, **kw),
                "additional": self.additional(images, **kw)}

    @staticmethod
    def unconditional(cond: dict) -> dict:
        return {k: torch.zeros_like(v) for k, v in cond.items()}
