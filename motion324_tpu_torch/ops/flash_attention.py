"""K1: flash attention forward over ``(B, H, S, 64)``.

:func:`flash_attention` launches the CUDA kernel ``csrc/flash_fwd.cu`` for a
CUDA tensor and computes :func:`flash_attention_reference` for a CPU tensor.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from motion324_tpu_torch.ops import _build

__all__ = ["flash_attention", "flash_attention_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def scale_in_dtype(q: torch.Tensor, scale: float | None) -> float:
    """The logit scale (default ``1/sqrt(D)``) rounded to q's dtype, as it is
    folded into q."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return float(torch.tensor(scale, dtype=q.dtype).item())


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """The kernels' math in plain PyTorch over ``(..., S, D)``: q pre-scaled
    in its own dtype, f32 logits, unnormalised ``exp(s - max)`` rounded to
    v's dtype for the second product, f32 sums, division last."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def flash_attention_reference(q, k, v, *, scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention`."""
    return attention_reference(q, k, v, scale_in_dtype(q, scale))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        fn = lib.m324_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention takes (B, H, S, D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v disagree on batch, heads or head dim")
    if q.shape[3] != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {q.shape[3]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape[2] == 0 or q.shape[2] == 0:
        raise ValueError("empty sequence")


def flash_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Exact attention ``softmax(q k^T * scale) v`` over ``(B, H, S, D)``.

    Returns ``(B, H, Sq, D)`` in q's dtype. ``scale`` defaults to
    ``1/sqrt(D)``.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    scale = scale_in_dtype(q, scale)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _load().m324_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, k.shape[2], scale, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
