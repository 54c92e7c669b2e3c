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

Tensor parallelism: the attention and MLP modules take an optional ``tp``
group (:class:`~motion324_tpu_torch.parallel.mesh.Group`). Their column
layers then hold this rank's ``H / mp`` heads (or ``hidden / mp`` MLP
units), *f* (:func:`copy_to_tp`) comes before them and *g*
(:func:`reduce_from_tp`) after the row layers; the per-head Q/K norms,
whose weight every rank applies to its own heads, sum that weight's
gradient over the group. Sequence parallelism:
:class:`SelfAttention` takes an ``sp`` group at call time and attends its
queries over the K/V of every rank's tokens, gathered in rank order; the
per-head Q/K RMSNorm stays local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.ops.attention import multi_head_attention
from motion324_tpu_torch.parallel.collectives import (all_gather_seq,
                                                      copy_to_tp,
                                                      reduce_from_tp)

__all__ = ["gelu", "GELU", "Linear", "LayerNorm", "RMSNorm", "MLP",
           "SelfAttention", "CrossAttention", "TransformerBlock",
           "CrossAttentionBlock", "tp_size", "tp_width", "row_linear"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU; the tanh approximation under bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


def tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def tp_width(width: int, heads: int, tp) -> int:
    """This rank's share of ``width`` split by head over ``tp``; raises when
    ``heads`` does not divide by the group's size."""
    mp = tp_size(tp)
    if heads % mp:
        raise ValueError(f"{heads} heads not divisible by mp={mp}")
    return width // mp


def row_linear(layer: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel layer: this rank's partial product, summed over
    ``tp``, then the bias once. With no group or a group of one, the layer
    itself."""
    if tp_size(tp) == 1:
        return layer(x)
    y = reduce_from_tp(F.linear(x, layer.weight.to(x.dtype)), tp)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


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
    """RMS normalisation over the last axis; statistics in f32. With ``tp``
    (a per-head norm inside a tensor-parallel attention, applied to this
    rank's heads) the weight's gradient is summed over the group."""

    def __init__(self, dim: int, eps: float = 1e-5, tp=None):
        super().__init__()
        self.eps = eps
        self.tp = tp
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * copy_to_tp(self.weight, self.tp).to(x.dtype)


class MLP(nn.Module):
    """Linear -> GELU -> Linear, no biases (``mlp.0`` / ``mlp.2``); with
    ``tp``, ``hidden / mp`` units on this rank."""

    def __init__(self, dim: int, mlp_ratio: int = 4, tp=None):
        super().__init__()
        self.tp = tp
        hidden = dim * mlp_ratio // tp_size(tp)
        self.mlp = nn.Sequential(Linear(dim, hidden, bias=False), GELU(),
                                 Linear(hidden, dim, bias=False))

    def forward(self, x):
        h = gelu(self.mlp[0](copy_to_tp(x, self.tp)))
        return row_linear(self.mlp[2], h, self.tp)


class SelfAttention(nn.Module):
    """Multi-head self-attention: fused ``to_qkv``, per-head QK-RMSNorm."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 attn_backend: str | None = None, tp=None):
        super().__init__()
        self.head_dim, self.tp = head_dim, tp
        self.dim = tp_width(dim, dim // head_dim, tp)   # this rank's heads
        self.attn_backend = attn_backend
        self.to_qkv = Linear(dim, 3 * self.dim, bias=False)
        self.fc = Linear(self.dim, dim, bias=False)
        if use_qk_norm:
            self.q_norm = RMSNorm(head_dim, tp=tp)
            self.k_norm = RMSNorm(head_dim, tp=tp)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x, sp=None):
        """``sp``: the sequence-parallel group whose ranks hold the other
        blocks of the sequence; K and V are gathered over it."""
        b, l, _ = x.shape
        nh = self.dim // self.head_dim
        q, k, v = self.to_qkv(copy_to_tp(x, self.tp)).split(self.dim, dim=-1)
        q = q.view(b, l, nh, self.head_dim)
        k = k.view(b, l, nh, self.head_dim)
        v = v.view(b, l, nh, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        k, v = all_gather_seq(k, 1, sp), all_gather_seq(v, 1, sp)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return row_linear(self.fc, out.reshape(b, l, self.dim), self.tp)


class CrossAttention(nn.Module):
    """Multi-head cross-attention with QK-RMSNorm."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 attn_backend: str | None = None, tp=None):
        super().__init__()
        self.head_dim, self.tp = head_dim, tp
        self.dim = tp_width(dim, dim // head_dim, tp)   # this rank's heads
        self.attn_backend = attn_backend
        self.to_q = Linear(dim, self.dim, bias=False)
        self.to_k = Linear(dim, self.dim, bias=False)
        self.to_v = Linear(dim, self.dim, bias=False)
        self.fc = Linear(self.dim, dim, bias=False)
        if use_qk_norm:
            self.q_norm = RMSNorm(head_dim, tp=tp)
            self.k_norm = RMSNorm(head_dim, tp=tp)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, query, key, value):
        b, lq, _ = query.shape
        lk = key.shape[1]
        nh = self.dim // self.head_dim
        query = copy_to_tp(query, self.tp)
        key = copy_to_tp(key, self.tp)
        value = key if value is key else copy_to_tp(value, self.tp)
        q = self.to_q(query).view(b, lq, nh, self.head_dim)
        k = self.to_k(key).view(b, lk, nh, self.head_dim)
        v = self.to_v(value).view(b, lk, nh, self.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return row_linear(self.fc, out.reshape(b, lq, self.dim), self.tp)


def _layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-5, bias=False)


class TransformerBlock(nn.Module):
    """``x + attn(ln(x))``, then ``x + mlp(ln(x))``."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 mlp_ratio: int = 4, attn_backend: str | None = None, tp=None):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = SelfAttention(dim, head_dim, use_qk_norm, attn_backend, tp)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, mlp_ratio, tp)

    def forward(self, x, sp=None):
        x = x + self.attn(self.norm1(x), sp)
        return x + self.mlp(self.norm2(x))


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention block; key and value share ``norm_kv``."""

    def __init__(self, dim: int, head_dim: int = 64, use_qk_norm: bool = True,
                 mlp_ratio: int = 4, attn_backend: str | None = None, tp=None):
        super().__init__()
        self.norm_q = _layer_norm(dim)
        self.norm_kv = _layer_norm(dim)
        self.attn = CrossAttention(dim, head_dim, use_qk_norm, attn_backend, tp)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, mlp_ratio, tp)

    def forward(self, query, key, value):
        kn = self.norm_kv(key)
        vn = kn if value is key else self.norm_kv(value)
        x = query + self.attn(self.norm_q(query), kn, vn)
        return x + self.mlp(self.norm2(x))
