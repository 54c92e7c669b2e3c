"""Pre-norm transformer blocks with per-head QK-RMSNorm.

Module and parameter names follow the reference checkpoint
(``norm1``, ``attn.to_qkv``, ``attn.q_norm``, ``mlp.mlp.0`` ...), so its
state dict loads with ``load_state_dict``. LayerNorms have no bias and eps
1e-5; RMSNorm statistics are taken in f32; GELU is exact except under bf16,
where it is the tanh form (as in the JAX package). All attention goes through
:func:`motion324_tpu_torch.ops.attention.multi_head_attention`.

Computation runs in the dtype of the activations. Parameters may be kept in
another dtype (f32 in training, as flax keeps ``param_dtype`` apart from
``dtype``) and are cast to the activations' dtype where they are used
(:class:`Linear`, :class:`LayerNorm`, :class:`RMSNorm`); with parameters
already in that dtype the casts do nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.ops.attention import multi_head_attention

__all__ = ["gelu", "GELU", "Linear", "LayerNorm", "RMSNorm", "MLP",
           "SelfAttention", "CrossAttention", "TransformerBlock",
           "CrossAttentionBlock"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU; the tanh approximation under bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


def _cast(p: torch.Tensor | None, dtype: torch.dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in the input's dtype (statistics in f32
    inside ``F.layer_norm``)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


class RMSNorm(nn.Module):
    """RMS normalisation over the last axis; statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight.to(x.dtype)


class MLP(nn.Module):
    """Linear -> GELU -> Linear, no biases (``mlp.0`` / ``mlp.2``)."""

    def __init__(self, dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.mlp = nn.Sequential(Linear(dim, dim * mlp_ratio, bias=False),
                                 GELU(),
                                 Linear(dim * mlp_ratio, dim, bias=False))

    def forward(self, x):
        return self.mlp(x)


class SelfAttention(nn.Module):
    """Multi-head self-attention: fused ``to_qkv``, per-head QK-RMSNorm."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 attn_backend: str | None = None):
        super().__init__()
        self.dim, self.head_dim = dim, head_dim
        self.attn_backend = attn_backend
        self.to_qkv = Linear(dim, 3 * dim, bias=False)
        self.fc = Linear(dim, dim, bias=False)
        if use_qk_norm:
            self.q_norm = RMSNorm(head_dim)
            self.k_norm = RMSNorm(head_dim)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x):
        b, l, _ = x.shape
        nh = self.dim // self.head_dim
        q, k, v = self.to_qkv(x).split(self.dim, dim=-1)
        q = q.view(b, l, nh, self.head_dim)
        k = k.view(b, l, nh, self.head_dim)
        v = v.view(b, l, nh, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return self.fc(out.reshape(b, l, self.dim))


class CrossAttention(nn.Module):
    """Multi-head cross-attention with QK-RMSNorm."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 attn_backend: str | None = None):
        super().__init__()
        self.dim, self.head_dim = dim, head_dim
        self.attn_backend = attn_backend
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.fc = Linear(dim, dim, bias=False)
        if use_qk_norm:
            self.q_norm = RMSNorm(head_dim)
            self.k_norm = RMSNorm(head_dim)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, query, key, value):
        b, lq, _ = query.shape
        lk = key.shape[1]
        nh = self.dim // self.head_dim
        q = self.to_q(query).view(b, lq, nh, self.head_dim)
        k = self.to_k(key).view(b, lk, nh, self.head_dim)
        v = self.to_v(value).view(b, lk, nh, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return self.fc(out.reshape(b, lq, self.dim))


def _layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-5, bias=False)


class TransformerBlock(nn.Module):
    """``x + attn(ln(x))``, then ``x + mlp(ln(x))``."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 mlp_ratio: int = 4, attn_backend: str | None = None):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = SelfAttention(dim, head_dim, use_qk_norm, attn_backend)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention block; key and value share ``norm_kv``."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 mlp_ratio: int = 4, attn_backend: str | None = None):
        super().__init__()
        self.norm_q = _layer_norm(dim)
        self.norm_kv = _layer_norm(dim)
        self.attn = CrossAttention(dim, head_dim, use_qk_norm, attn_backend)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, mlp_ratio)

    def forward(self, query, key, value):
        kn = self.norm_kv(key)
        vn = kn if value is key else self.norm_kv(value)
        x = query + self.attn(self.norm_q(query), kn, vn)
        return x + self.mlp(self.norm2(x))
