"""Hunyuan3D-2.1's shape DiT (``hunyuan3d-dit-v2-1``, ``HunYuanDiTPlain``):
a plain pre-norm transformer over the latents with cross-attention to the
image condition, U-ViT long skips, and a mixture of experts in its last
blocks.

For latents x (B, L, C), sigma t (B,) and condition tokens c (B, Lc, Cc):

- the timestep is one token prepended to the latents:
  ``W2 GELU(W1 sincos(1000 t) + b1) + b2`` (``t_embedder.mlp``; the
  sinusoidal embedding of width ``hidden_size``, cos first, max period
  10 000), then ``[t_tok ; x_embedder(x)]``; no positional embedding;
- block l (``depth`` of them): for l > depth // 2 first
  ``x = skip_norm(skip_linear([skip ; x]))`` with the skip the output of
  block depth - 1 - l (a last-in, first-out stack of the first
  depth // 2 blocks' outputs); then
  ``x += attn1(norm1(x))``, ``x += attn2(norm2(x), c)``,
  ``x += ffn(norm3(x))``: self- and cross-attention with Q, K, V without
  bias, per-head RMSNorm of q and k (eps 1e-6, with a scale), an output
  projection with bias; the FFN an exact-GELU MLP, or in the last
  ``num_moe_layers`` blocks the mixture of experts
  (:class:`~motion324_tpu_torch.hy3dgen.moe.MoE`). No timestep modulation
  inside the blocks;
- the final layer drops the timestep token:
  ``linear(norm_final(x)[:, 1:])``.

LayerNorms have eps 1e-6 and an affine. Computation runs in the dtype of
the parameters; the velocity comes back in f32. Attention goes through
:func:`motion324_tpu_torch.ops.attention.multi_head_attention`: at the
release shapes (16 heads of 128, 4 097 tokens, 1 370 condition tokens)
both attentions take K1 at head dim 128.
"""

from __future__ import annotations

import torch
from torch import nn

from motion324_tpu_torch.hy3dgen.dit import timestep_embedding
from motion324_tpu_torch.hy3dgen.moe import MLP, MoE
from motion324_tpu_torch.models.transformer import LayerNorm, Linear, RMSNorm
from motion324_tpu_torch.ops.attention import multi_head_attention

__all__ = ["Hunyuan3DDiT21"]


class _TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dim = dim
        self.mlp = nn.Sequential(Linear(dim, hidden), nn.GELU(),
                                 Linear(hidden, dim))

    def forward(self, t, dtype):
        return self.mlp(timestep_embedding(t, self.dim, max_period=10000.0,
                                           time_factor=1000.0).to(dtype))


class _Attention(nn.Module):
    """Q from x, K and V from ``context`` (x itself for self-attention),
    per-head RMSNorm of q and k, the output projection ``out_proj``."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 attn_backend: str | None):
        super().__init__()
        self.num_heads, self.attn_backend = num_heads, attn_backend
        head = dim // num_heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim, dim, bias=False)
        self.to_v = Linear(context_dim, dim, bias=False)
        self.q_norm = RMSNorm(head, eps=1e-6)
        self.k_norm = RMSNorm(head, eps=1e-6)
        self.out_proj = Linear(dim, dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, l, c = x.shape
        heads = lambda t: t.view(b, t.shape[1], self.num_heads, -1)
        q = self.q_norm(heads(self.to_q(x)))
        k = self.k_norm(heads(self.to_k(context)))
        out = multi_head_attention(q, k, heads(self.to_v(context)),
                                   backend=self.attn_backend)
        return self.out_proj(out.reshape(b, l, c))


class DiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 mlp_ratio: float, skip: bool, moe: bool, num_experts: int,
                 attn_backend: str | None = None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        if skip:
            self.skip_linear = Linear(2 * dim, dim)
            self.skip_norm = LayerNorm(dim, eps=1e-6)
        else:
            self.skip_linear = self.skip_norm = None
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = _Attention(dim, num_heads, dim, attn_backend)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = _Attention(dim, num_heads, context_dim, attn_backend)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        if moe:
            self.moe = MoE(dim, hidden, num_experts)
        else:
            self.mlp = MLP(dim, hidden)

    def forward(self, x, cond, skip=None):
        if self.skip_linear is not None:
            x = self.skip_norm(self.skip_linear(torch.cat([skip, x], dim=-1)))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), cond)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.norm3(x))


class _FinalLayer(nn.Module):
    def __init__(self, dim: int, out_channels: int):
        super().__init__()
        self.norm_final = LayerNorm(dim, eps=1e-6)
        self.linear = Linear(dim, out_channels)

    def forward(self, x):
        return self.linear(self.norm_final(x[:, 1:]))


class Hunyuan3DDiT21(nn.Module):
    """x (B, L, 64), t (B,), cond (B, Lc, 1024) -> velocity (B, L, 64) f32.
    Defaults are the release's widths."""

    def __init__(self, in_channels: int = 64, context_dim: int = 1024,
                 hidden_size: int = 2048, num_heads: int = 16,
                 depth: int = 21, mlp_ratio: float = 4.0,
                 num_moe_layers: int = 6, num_experts: int = 8,
                 attn_backend: str | None = None):
        super().__init__()
        self.depth = depth
        self.x_embedder = Linear(in_channels, hidden_size)
        self.t_embedder = _TimestepEmbedder(hidden_size,
                                            int(hidden_size * mlp_ratio))
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, num_heads, context_dim, mlp_ratio,
                     skip=layer > depth // 2,
                     moe=depth - layer <= num_moe_layers,
                     num_experts=num_experts, attn_backend=attn_backend)
            for layer in range(depth))
        self.final_layer = _FinalLayer(hidden_size, in_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.x_embedder.weight.dtype

    def forward(self, x, t, cond):
        dtype = self.dtype
        x = torch.cat([self.t_embedder(t, dtype)[:, None],
                       self.x_embedder(x.to(dtype))], dim=1)
        cond = cond.to(dtype)
        skips = []
        for layer, blk in enumerate(self.blocks):
            x = blk(x, cond, skips.pop() if blk.skip_linear is not None
                    else None)
            if layer < self.depth // 2:
                skips.append(x)
        return self.final_layer(x).float()
