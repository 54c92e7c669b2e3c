"""K9 (forward and backward): short attention over ``(B, H, S, 64)``, the
``"short_legacy"`` attention backend.

:func:`short_attention` flattens ``(B, H)`` into slices, ``(B*H, S, 64)``
(a view where the strides allow it, else a copy) and is differentiable. A
call that needs no gradient launches ``csrc/short_fwd.cu`` without the LSE
output (``short_attention.launches``); the logit scale, rounded to q's
dtype, is folded into q as the kernel loads it. A call with an input that
requires grad multiplies q by the scale in q's dtype (autograd carries
``dq * scale``) and runs :class:`ShortAttentionFn` on the scaled q: its
forward launches the same kernel with the compact f32 LSE ``(B*H, Sq)``
(``short_attention.lse_launches``) and saves ``(q, k, v, o, lse)``; its
backward is :func:`short_attention_bwd`, which launches
``csrc/short_bwd.cu`` (``short_attention_bwd.launches``). On a CPU tensor
every step computes its plain version instead, at any head dim.

The semantics are those of the JAX package's ``short_attention``: q
pre-scaled in its own dtype, keys past the KV length masked, one softmax
over all keys with P rounded to v's dtype before P V and the division last,
the LSE in f32; the backward's P in f32, P rounded to dO's dtype for dV, dS
rounded to q's dtype for dQ and dK. The TPU kernel pads queries to 16s and
keys to 128s; the CUDA kernels mask instead, which gives the same numbers.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops.flash_attention import (
    _DTYPES, _load, _stream, attention_reference,
    flash_attention_bwd_reference, scale_in_dtype)

__all__ = ["short_attention", "short_attention_reference",
           "short_attention_bwd", "short_attention_bwd_reference",
           "ShortAttentionFn"]

_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])


def short_attention_reference(q, k, v, *, scale: float | None = None,
                              with_lse: bool = False):
    """Plain PyTorch version of :func:`short_attention` over ``(..., S, D)``:
    q multiplied by the scale (default ``1/sqrt(D)``) in its own dtype, f32
    logits, ``exp(s - max)`` over all keys rounded to v's dtype for P V, f32
    sums, the division last, the output in q's dtype. With ``with_lse`` also
    returns the f32 log-sum-exp, ``(prod(leading dims), Sq)``."""
    out = attention_reference(q, k, v, scale_in_dtype(q, scale), with_lse)
    if not with_lse:
        return out
    return out[0], out[1].reshape(-1, q.shape[-2])


def short_attention_bwd_reference(q, k, v, o, lse, do):
    """Plain PyTorch version of the K9 backward over ``(..., S, D)`` for q
    already multiplied by the logit scale: P = exp(q k^T - lse) in f32,
    ``delta = rowsum(dO * O)`` in f32, P rounded to dO's dtype for dV, dS
    rounded to q's dtype for dQ and dK, f32 sums. ``lse`` holds
    ``q.shape[:-1]`` values. Returns ``(dq, dk, dv)`` with respect to the
    scaled q, k and v."""
    return flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)


def _check(name, t, like):
    if t.dim() != 3 or t.shape[2] != 64:
        raise ValueError(f"the CUDA kernel takes (B*H, S, 64) {name}, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES or t.dtype != like.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 inputs of "
                        f"one dtype, got {name} {t.dtype} and {like.dtype}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.shape[1] == 0:
        raise ValueError(f"empty sequence in {name}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} must have unit stride within a row")
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(t.stride(i) % per16 and t.shape[i] > 1
                                for i in (0, 1)):
        raise ValueError(f"{name}'s rows are not 16-byte aligned")


def _check_qkv(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"q, k and v disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _forward(q, k, v, scale: float, with_lse: bool):
    """``(out, lse or None)`` over ``(B*H, S, D)`` slices: the kernel on
    CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        if not with_lse:
            return short_attention_reference(q, k, v, scale=scale), None
        return short_attention_reference(q, k, v, scale=scale, with_lse=True)
    _check_qkv(q, k, v)
    bh, sq, _ = q.shape
    out = torch.empty((bh, sq, 64), dtype=q.dtype, device=q.device)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _load("short_fwd", _FWD_ARGS).m324_short_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq, k.shape[1],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), scale, _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"short_fwd launch failed: CUDA error {rc}")
    if with_lse:
        short_attention.lse_launches += 1
    else:
        short_attention.launches += 1
    return out, lse


def short_attention_bwd(q, k, v, o, lse, do):
    """Gradients ``(dq, dk, dv)``, contiguous ``(B*H, S, 64)``, with respect
    to the pre-scaled q, k and v, from the forward's ``o`` and compact f32
    ``lse`` ``(B*H, Sq)``. CUDA: the K9 backward; CPU:
    :func:`short_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return short_attention_bwd_reference(q, k, v, o, lse, do)
    _check_qkv(q, k, v)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError("dO and O must have q's shape")
    _check("o", o, q)
    _check("dO", do, q)
    bh, sq, _ = q.shape
    sk = k.shape[1]
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(bh, sq)}")
    dq = torch.empty((bh, sq, 64), dtype=q.dtype, device=q.device)
    dk = torch.empty((bh, sk, 64), dtype=k.dtype, device=k.device)
    dv = torch.empty((bh, sk, 64), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        rc = _load("short_bwd", _BWD_ARGS).m324_short_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, sq, sk, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), o.stride(0), o.stride(1),
            do.stride(0), do.stride(1), _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"short_bwd launch failed: CUDA error {rc}")
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_bwd.launches = 0


class ShortAttentionFn(torch.autograd.Function):
    """Short attention over ``(B*H, S, D)`` slices with q already multiplied
    by the logit scale; the forward saves the compact f32 LSE ``(B*H, Sq)``
    for the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, 1.0, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return short_attention_bwd(q, k, v, out, lse, do)


def short_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Exact attention ``softmax(q k^T * scale) v`` over ``(B, H, S, D)``.

    Returns ``(B, H, Sq, D)`` in q's dtype. ``scale`` defaults to
    ``1/sqrt(D)``. Differentiable (see the module docstring); a CUDA tensor
    with D other than 64 raises.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"short_attention takes (B, H, S, D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    scale = scale_in_dtype(q, scale)
    flat = lambda x: x.reshape(b * h, x.shape[2], d)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = ShortAttentionFn.apply(flat(q * scale), flat(k), flat(v))
    else:
        out = _forward(flat(q), flat(k), flat(v), scale, with_lse=False)[0]
    return out.reshape(b, h, sq, d)


short_attention.launches = 0
short_attention.lse_launches = 0
