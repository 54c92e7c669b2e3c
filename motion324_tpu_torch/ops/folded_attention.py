"""K2: head-folded short attention forward over model-native ``(B, S, H*64)``.

:func:`folded_attention` launches the CUDA kernel ``csrc/folded_fwd.cu`` for a
CUDA tensor and computes :func:`folded_attention_reference` for a CPU tensor.
q, k and v are read through their strides (the q/k/v views of a fused QKV
projection go in without a copy); the output is contiguous ``(B, Sq, H*64)``.
``folded_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops import _build
from motion324_tpu_torch.ops.flash_attention import (attention_reference,
                                                     scale_in_dtype)

__all__ = ["folded_attention", "folded_attention_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


def folded_attention_reference(q, k, v, *, heads: int,
                               scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`folded_attention`."""
    b, sq, c = q.shape
    qh = _heads_first(q, heads)
    out = attention_reference(qh, _heads_first(k, heads),
                              _heads_first(v, heads), scale_in_dtype(qh, scale))
    return out.transpose(1, 2).reshape(b, sq, c)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("folded_fwd")
        fn = lib.m324_folded_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def folded_attention(q, k, v, *, heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """Exact multi-head attention over ``(B, S, H*D)`` tensors.

    Returns ``(B, Sq, H*D)`` in q's dtype. ``scale`` defaults to
    ``1/sqrt(D)``.
    """
    if q.device.type == "cpu":
        return folded_attention_reference(q, k, v, heads=heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"folded_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, heads)
    scale = scale_in_dtype(q, scale if scale is not None
                           else (q.shape[2] // heads) ** -0.5)
    b, sq, c = q.shape
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _load().m324_folded_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, heads, sq, k.shape[1], q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), scale, _DTYPES[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"folded_fwd launch failed: CUDA error {rc}")
    folded_attention.launches += 1
    return out


folded_attention.launches = 0
