"""Attention dispatch: the one entry point for all attention in the port.

Routing follows the KV and query lengths, with the thresholds of the JAX
package (``motion324_tpu/ops/attention.py``):

- KV >= 1024: the flash route;
- 128 <= KV < 1024 and Sq >= 128: K2, the head-folded kernel, when the
  padded logit tile (Sq to 16s, KV to 128s) is at most 512 x 512, else the
  flash route (the ShapeVAE volume query: 8 192 points x 512 latents);
- otherwise (tiny KV, e.g. decoding points against 64 mesh tokens): plain
  PyTorch.

The flash route launches K6, the single-KV kernel, where the KV fits one
block (KV 1024 itself, and the volume query's 512), else K1, the online
softmax over KV tiles (:func:`~motion324_tpu_torch.ops.flash_attention.
single_kv_route`).

A kernel route on a CUDA tensor launches the kernel; on a CPU tensor the
kernel's wrapper computes its plain version.

``backend`` forces a route, with the JAX package's names: ``"xla"`` the
plain path (``"plain"`` is the same, the name the port's comparisons use);
``"flash"`` the flash route (K6 or K1 as above); ``"short"`` K2;
``"short_legacy"`` K9, the short-attention kernel over ``(B, H, S, 64)``
(:mod:`motion324_tpu_torch.ops.short_attention`). The JAX package's
interpreter modes (``"interpret"``, ``"*_interpret"``) are for its CPU tests
and are refused here, as is any other name.
"""

from __future__ import annotations

import math

import torch

from motion324_tpu_torch.ops.flash_attention import flash_attention
from motion324_tpu_torch.ops.folded_attention import folded_attention
from motion324_tpu_torch.ops.short_attention import short_attention

__all__ = ["multi_head_attention", "mha_reference", "select_route",
           "BACKENDS"]

FLASH_MIN_KV = 1024
SHORT_MIN_KV = 128
SHORT_MIN_Q = 128
SHORT_MAX_AREA = 512 * 512

# forced routes by backend name
BACKENDS = {"plain": "plain", "xla": "plain", "flash": "flash",
            "short": "folded", "short_legacy": "short_legacy"}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def select_route(sq: int, sk: int) -> str:
    """``"flash"``, ``"folded"`` or ``"plain"`` for query/KV lengths."""
    if sk >= FLASH_MIN_KV:
        return "flash"
    if sk >= SHORT_MIN_KV and sq >= SHORT_MIN_Q:
        area = _ceil_to(sq, 16) * _ceil_to(sk, 128)
        return "folded" if area <= SHORT_MAX_AREA else "flash"
    return "plain"


def mha_reference(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Exact attention over ``(B, S, H, D)`` in plain PyTorch: f32 logits and
    softmax, weights rounded to v's dtype, f32 sums, output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(q, k, v, *, scale: float | None = None,
                         backend: str | None = None) -> torch.Tensor:
    """Multi-head attention over ``(B, S, H, D)`` tensors.

    ``backend``: ``None`` routes by shape; a name of ``BACKENDS`` forces a
    route (see the module docstring). Returns ``(B, Sq, H, D)``.
    """
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    route = select_route(sq, sk) if backend is None else BACKENDS[backend]
    if route == "plain":
        return mha_reference(q, k, v, scale=scale)
    if route == "folded":
        out = folded_attention(q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
                               v.reshape(b, sk, h * d), heads=h, scale=scale)
        return out.reshape(b, sq, h, d)

    if route == "short_legacy":
        # K9 reads the (B, H, S, D) views through their strides and writes
        # its output heads-last, as K1 does: neither way needs a copy
        out = short_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=scale)
        return out.transpose(1, 2)

    # K1 reads the (B, H, S, D) views through their strides and writes its
    # output heads-last, so neither way needs a copy (K6 and a
    # differentiated call copy inside flash_attention)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2)
