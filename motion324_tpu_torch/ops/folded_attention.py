"""K2 (forward) and K5 (backward): head-folded short attention over
model-native ``(B, S, H*64)``.

:func:`folded_attention` is differentiable. A call that needs no gradient
(DINOv2, under ``torch.no_grad``) launches ``csrc/folded_fwd.cu`` without
the LSE output (``folded_attention.launches``). A call with an input that
requires grad multiplies q by the logit scale in q's dtype and runs
:class:`FoldedAttentionFn`: its forward launches the same kernel with the
per-head f32 LSE ``(B, Sq, H)`` (``folded_attention.lse_launches``), its
backward is :func:`folded_attention_bwd`, which launches K5
(``csrc/folded_bwd.cu``; ``folded_attention_bwd.launches``). On a CPU tensor
every step computes its plain version instead. q, k and v are read through
their strides (the q/k/v views of a fused QKV projection go in without a
copy); outputs are contiguous ``(B, S, H*64)``.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops.flash_attention import (
    _DTYPES, _load, _stream, attention_reference,
    flash_attention_bwd_reference, scale_in_dtype)

__all__ = ["folded_attention", "folded_attention_reference",
           "folded_attention_bwd", "folded_attention_bwd_reference",
           "FoldedAttentionFn"]

_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _default_scale(q, heads, scale):
    return scale_in_dtype(q, scale if scale is not None
                          else (q.shape[2] // heads) ** -0.5)


def folded_attention_reference(q, k, v, *, heads: int,
                               scale: float | None = None,
                               with_lse: bool = False):
    """Plain PyTorch version of :func:`folded_attention`. With ``with_lse``,
    returns ``(out, lse)`` as the forward kernel's LSE variant does, lse f32
    ``(B, Sq, H)``."""
    hf = lambda x: _heads_first(x, heads)
    out = attention_reference(hf(q), hf(k), hf(v),
                              _default_scale(q, heads, scale), with_lse)
    if not with_lse:
        return _heads_last(out)
    return _heads_last(out[0]), out[1].transpose(1, 2).contiguous()


def folded_attention_bwd_reference(q, k, v, o, lse, do, *, heads: int,
                                   scale: float | None = None):
    """Plain PyTorch version of K5: the backward of
    :func:`flash_attention_bwd_reference` per head, on ``(B, S, H*64)``
    tensors and the per-head ``lse`` ``(B, Sq, H)``; delta is computed from
    ``o`` and ``do``. Returns contiguous ``(dq, dk, dv)``."""
    hf = lambda x: _heads_first(x, heads)
    dq, dk, dv = flash_attention_bwd_reference(
        hf(q), hf(k), hf(v), hf(o), lse.transpose(1, 2), hf(do),
        scale=_default_scale(q, heads, scale))
    return _heads_last(dq), _heads_last(dk), _heads_last(dv)


def _check(q, k, v, heads):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"folded_attention takes (B, S, H*D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, c = q.shape
    if k.shape[0] != b or k.shape[2] != c:
        raise ValueError("q and k/v disagree on batch or width")
    if c != 64 * heads:
        raise ValueError(f"the CUDA kernel takes head dim 64, got width {c} "
                         f"for {heads} heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} must have unit stride within a row")
        if t.data_ptr() % 16 or any(t.stride(i) % per16 and t.shape[i] > 1
                                    for i in (0, 1)):
            raise ValueError(f"{name}'s rows are not 16-byte aligned")
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("empty sequence")


def _forward(q, k, v, heads: int, scale: float, with_lse: bool):
    """``(out, lse or None)``: the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        out = folded_attention_reference(q, k, v, heads=heads, scale=scale,
                                         with_lse=with_lse)
        return out if with_lse else (out, None)
    _check(q, k, v, heads)
    b, sq, c = q.shape
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, sq, heads), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _load("folded_fwd", _FWD_ARGS).m324_folded_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, heads, sq, k.shape[1],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), scale, _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"folded_fwd launch failed: CUDA error {rc}")
    if with_lse:
        folded_attention.lse_launches += 1
    else:
        folded_attention.launches += 1
    return out, lse


def folded_attention_bwd(q, k, v, o, lse, do, *, heads: int):
    """Gradients ``(dq, dk, dv)``, contiguous ``(B, S, H*64)``, with respect
    to the pre-scaled q, k and v, from the forward's ``o`` and per-head f32
    ``lse`` ``(B, Sq, H)``. CUDA: K5; CPU:
    :func:`folded_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return folded_attention_bwd_reference(q, k, v, o, lse, do, heads=heads,
                                              scale=1.0)
    _check(q, k, v, heads)
    b, sq, c = q.shape
    sk = k.shape[1]
    do = do.contiguous()
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO and O must have q's shape and dtype")
    _check(o, do, do, heads)
    if lse.shape != (b, sq, heads) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b, sq, heads)}")
    dk = torch.empty((b, sk, c), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, c), dtype=v.dtype, device=v.device)
    if q.dtype == torch.float32:
        dq = torch.zeros((b, sq, c), dtype=q.dtype, device=q.device)
        acc = dq
    else:
        dq = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
        acc = torch.zeros((b, sq, c), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _load("folded_bwd", _BWD_ARGS).m324_folded_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), acc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, heads, sq, sk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), o.stride(0), o.stride(1), do.stride(0), do.stride(1),
            _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"folded_bwd launch failed: CUDA error {rc}")
    folded_attention_bwd.launches += 1
    return dq, dk, dv


folded_attention_bwd.launches = 0


class FoldedAttentionFn(torch.autograd.Function):
    """Head-folded attention with q already multiplied by the logit scale;
    the forward saves the per-head f32 LSE ``(B, Sq, H)``."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        out, lse = _forward(q, k, v, heads, 1.0, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*folded_attention_bwd(q, k, v, out, lse, do, heads=ctx.heads),
                None)


def folded_attention(q, k, v, *, heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """Exact multi-head attention over ``(B, S, H*D)`` tensors.

    Returns ``(B, Sq, H*D)`` in q's dtype. ``scale`` defaults to
    ``1/sqrt(D)``. Differentiable (see the module docstring).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"folded_attention runs on cuda or cpu, not {q.device}")
    scale = _default_scale(q, heads, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FoldedAttentionFn.apply(q * scale, k, v, heads)
    return _forward(q, k, v, heads, scale, with_lse=False)[0]


folded_attention.launches = 0
folded_attention.lse_launches = 0
