"""DINOv2 ViT-B/14 image encoder (frozen feature extractor).

Parameter names follow torch-hub ``dinov2_vitb14`` (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``ls1.gamma`` ...). Patchify conv -> CLS token ->
position table resized from the 37 x 37 grid of the 518-px pretraining
resolution (bicubic, antialiased, as DINOv2's ``interpolate_pos_encoding``)
-> pre-norm blocks with LayerScale (LayerNorm eps 1e-6 with bias) -> final
LayerNorm. Returns the patch tokens (CLS dropped).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.models.transformer import GELU, LayerNorm, Linear
from motion324_tpu_torch.ops.attention import multi_head_attention

__all__ = ["DinoViT", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_backend: str | None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_backend = attn_backend
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, l, c = x.shape
        hd = c // self.num_heads
        q, k, v = (t.view(b, l, self.num_heads, hd)
                   for t in self.qkv(x).split(c, dim=-1))
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return self.proj(out.reshape(b, l, c))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 attn_backend: str | None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, num_heads, attn_backend)
        self.ls1 = _LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, dim * mlp_ratio)
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    """Frozen DINOv2 encoder: ``(B, H, W, 3)`` in [0, 1] ->
    ``(B, (H/14)*(W/14), C)`` patch tokens, computed in the images' dtype."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 native_grid: int = 37, mlp_ratio: int = 4,
                 attn_backend: str | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.native_grid = native_grid
        self.patch_embed = _PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + native_grid ** 2, embed_dim))
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, attn_backend)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def _patch_pos(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos_embed[:, 1:]
        n = self.native_grid
        if (gh, gw) == (n, n):
            return pos
        c = pos.shape[-1]
        grid = pos.float().reshape(1, n, n, c).permute(0, 3, 1, 2)
        out = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                            antialias=True, align_corners=False)
        return out.permute(0, 2, 3, 1).reshape(1, gh * gw, c)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
        std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        proj = self.patch_embed.proj
        x = F.conv2d(x, proj.weight.to(x.dtype), proj.bias.to(x.dtype),
                     stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)
        x = x + self._patch_pos(gh, gw).to(x.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(x.dtype)
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:]
