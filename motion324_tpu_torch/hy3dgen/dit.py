"""Latent-set flow-matching DiT denoiser (Flux-style), Hunyuan3D-2's shape
model.

16 double-stream blocks (separate latent and condition streams with joint
attention over ``[txt | img]``) and 32 single-stream blocks (fused qkv + MLP
over ``[cond | latent]``), adaLN modulation from the timestep embedding,
per-head QK-RMSNorm (eps 1e-6, statistics in f32), tanh-GELU MLPs and a
final adaLN layer. Defaults are the release config (in 64, cond 1536, hidden
1024, 16 heads). Module and parameter names follow the reference checkpoint
(``double_blocks.{i}.img_attn.qkv``, ``.img_attn.norm.query_norm.scale``,
``single_blocks.{i}.linear1``, ``final_layer.adaLN_modulation.1`` ...), so
its ``model`` state dict loads with ``load_state_dict``. Computation runs in
the dtype of the parameters; the velocity comes back in f32. Attention goes
through :func:`motion324_tpu_torch.ops.attention.multi_head_attention`: K1
at the release shapes (1 881 tokens). The QK-RMSNorm, the modulated norms,
the gated residuals and the single blocks' GELU + concat go through
:mod:`motion324_tpu_torch.ops.dit_fused`: one launch each on the card, the
plain expressions elsewhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.models.transformer import Linear
from motion324_tpu_torch.ops.attention import multi_head_attention
from motion324_tpu_torch.ops.dit_fused import (dit_gate, dit_gelu_cat,
                                               dit_modulate, dit_rmsnorm)

__all__ = ["Hunyuan3DDiT", "timestep_embedding"]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding of ``time_factor * t``, cos first, in f32."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class _RMSNorm(nn.Module):
    """RMS normalisation over the head dim, statistics in f32, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return dit_rmsnorm(x, self.scale)


class _QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = _RMSNorm(dim)
        self.key_norm = _RMSNorm(dim)


class _MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden)
        self.out_layer = Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class _Modulation(nn.Module):
    """``lin(silu(vec))`` split into (shift, scale, gate), twice for a
    double block."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Linear(dim, self.mult * dim)

    def forward(self, vec):
        parts = self.lin(F.silu(vec))[:, None, :].chunk(self.mult, dim=-1)
        return parts[:3], (parts[3:] if self.mult == 6 else None)


class _SelfAttention(nn.Module):
    """qkv + per-head QK-RMSNorm, and the output projection ``proj``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.norm = _QKNorm(dim // num_heads)
        self.proj = Linear(dim, dim)

    def qkv_heads(self, x):
        """(q, k, v), each (B, L, H, D)."""
        b, l, c = x.shape
        q, k, v = (t.reshape(b, l, self.num_heads, c // self.num_heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        return self.norm.query_norm(q), self.norm.key_norm(k), v


def _mlp(dim: int, hidden: int) -> nn.Sequential:
    # reference layout: Sequential(Linear, GELU(tanh), Linear)
    return nn.Sequential(Linear(dim, hidden), nn.GELU(approximate="tanh"),
                         Linear(hidden, dim))


class DoubleStreamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attn_backend: str | None = None):
        super().__init__()
        mlp_dim = int(dim * mlp_ratio)
        self.attn_backend = attn_backend
        self.img_mod = _Modulation(dim, True)
        self.img_attn = _SelfAttention(dim, num_heads, qkv_bias)
        self.img_mlp = _mlp(dim, mlp_dim)
        self.txt_mod = _Modulation(dim, True)
        self.txt_attn = _SelfAttention(dim, num_heads, qkv_bias)
        self.txt_mlp = _mlp(dim, mlp_dim)

    def forward(self, img, txt, vec):
        (im1_shift, im1_scale, im1_gate), (im2_shift, im2_scale, im2_gate) = \
            self.img_mod(vec)
        (tx1_shift, tx1_scale, tx1_gate), (tx2_shift, tx2_scale, tx2_gate) = \
            self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_heads(
            dit_modulate(img, im1_shift, im1_scale))
        tq, tk, tv = self.txt_attn.qkv_heads(
            dit_modulate(txt, tx1_shift, tx1_scale))
        # joint attention over [txt | img]
        attn = multi_head_attention(torch.cat([tq, iq], 1),
                                    torch.cat([tk, ik], 1),
                                    torch.cat([tv, iv], 1),
                                    backend=self.attn_backend)
        attn = attn.reshape(*attn.shape[:2], -1)
        lt = txt.shape[1]
        txt_attn, img_attn = attn[:, :lt], attn[:, lt:]

        img = dit_gate(img, im1_gate, self.img_attn.proj(img_attn))
        img = dit_gate(img, im2_gate, self.img_mlp(
            dit_modulate(img, im2_shift, im2_scale)))
        txt = dit_gate(txt, tx1_gate, self.txt_attn.proj(txt_attn))
        txt = dit_gate(txt, tx2_gate, self.txt_mlp(
            dit_modulate(txt, tx2_shift, tx2_scale)))
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_backend: str | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.mlp_dim = int(dim * mlp_ratio)
        self.attn_backend = attn_backend
        self.modulation = _Modulation(dim, False)
        self.linear1 = Linear(dim, 3 * dim + self.mlp_dim)
        self.linear2 = Linear(dim + self.mlp_dim, dim)
        self.norm = _QKNorm(dim // num_heads)

    def forward(self, x, vec):
        b, l, _ = x.shape
        hd = self.dim // self.num_heads
        (shift, scale, gate), _ = self.modulation(vec)
        qkv, mlp = self.linear1(dit_modulate(x, shift, scale)).split(
            [3 * self.dim, self.mlp_dim], dim=-1)
        q, k, v = (t.reshape(b, l, self.num_heads, hd)
                   for t in qkv.chunk(3, dim=-1))
        attn = multi_head_attention(self.norm.query_norm(q),
                                    self.norm.key_norm(k), v,
                                    backend=self.attn_backend)
        out = self.linear2(dit_gelu_cat(attn.reshape(b, l, self.dim), mlp))
        return dit_gate(x, gate, out)


class _LastLayer(nn.Module):
    def __init__(self, dim: int, out_channels: int):
        super().__init__()
        # reference layout: adaLN_modulation = Sequential(SiLU, Linear)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(dim, 2 * dim))
        self.linear = Linear(dim, out_channels)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec)[:, None, :].chunk(2, dim=-1)
        return self.linear(dit_modulate(x, shift, scale))


class Hunyuan3DDiT(nn.Module):
    """x (B, L, 64), t (B,), cond (B, Lc, 1536) -> velocity (B, L, 64) f32."""

    def __init__(self, in_channels: int = 64, context_in_dim: int = 1536,
                 hidden_size: int = 1024, mlp_ratio: float = 4.0,
                 num_heads: int = 16, depth: int = 16,
                 depth_single_blocks: int = 32, time_factor: float = 1000.0,
                 qkv_bias: bool = True, attn_backend: str | None = None):
        super().__init__()
        self.time_factor = time_factor
        self.latent_in = Linear(in_channels, hidden_size)
        self.time_in = _MLPEmbedder(256, hidden_size)
        self.cond_in = Linear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias,
                              attn_backend) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio, attn_backend)
            for _ in range(depth_single_blocks))
        self.final_layer = _LastLayer(hidden_size, in_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.latent_in.weight.dtype

    def forward(self, x, t, cond):
        dtype = self.dtype
        latent = self.latent_in(x.to(dtype))
        # the reference passes time_factor positionally into max_period, so
        # the released model runs with max_period = time_factor = 1000
        vec = self.time_in(timestep_embedding(
            t, 256, max_period=self.time_factor, time_factor=1000.0).to(dtype))
        cond = self.cond_in(cond.to(dtype))
        for blk in self.double_blocks:
            latent, cond = blk(latent, cond, vec)
        merged = torch.cat([cond, latent], dim=1)
        for blk in self.single_blocks:
            merged = blk(merged, vec)
        latent = merged[:, cond.shape[1]:]
        return self.final_layer(latent, vec).float()
