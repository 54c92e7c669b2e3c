"""K7: voxel-masked flash attention (turbo multiview), ``csrc/masked_flash.cu``.

Replaces the TPU kernel ``_fwd_kernel`` of
``motion324_tpu/ops/masked_attention.py``: self-attention over ``(B, H, S,
D)`` restricted to the token pairs whose voxel-cell positions (``(B, S, 3)``,
shared by the heads) lie within ``radius``,

    d2 = |pq|^2 + |pk|^2 - 2 pq.pk < radius^2,

evaluated in f32 in that order (:func:`voxel_keep`). The mask is never
stored: the kernel rebuilds it per tile from the positions. Masked logits
are -1e30; each real token keeps its own key, so no real row is fully
masked. Forward only: turbo texturing is inference.

:func:`masked_flash_attention` launches K7 on CUDA tensors (counted in
``masked_flash_attention.launches``) and computes
:func:`masked_attention_reference` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops import _build
from motion324_tpu_torch.ops.flash_attention import scale_in_dtype

__all__ = ["masked_flash_attention", "masked_attention_reference",
           "voxel_keep"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def _norm2(p: torch.Tensor) -> torch.Tensor:
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def voxel_keep(pq: torch.Tensor, pk: torch.Tensor, radius: float) -> torch.Tensor:
    """``(B, Sq, Sk)`` bool: ``|pq|^2 + |pk|^2 - 2 pq.pk < r^2`` in f32, each
    sum taken left to right as the kernel takes it, for ``(B, S, 3)``
    positions."""
    pq, pk = pq.float(), pk.float()
    a, b = pq[:, :, None], pk[:, None]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    d2 = (_norm2(pq)[:, :, None] + _norm2(pk)[:, None]) - 2.0 * cross
    return d2 < torch.tensor(float(radius) ** 2, dtype=torch.float32)


def masked_attention_reference(q, k, v, positions, *, radius: float,
                               scale: float | None = None,
                               kv_positions=None) -> torch.Tensor:
    """The kernel's math in plain PyTorch over ``(B, H, S, D)``: q pre-scaled
    in its own dtype, f32 logits, -1e30 where :func:`voxel_keep` is false,
    ``exp(s - max)`` rounded to v's dtype for the second product, f32 sums,
    division by ``max(l, 1e-30)`` last. ``kv_positions`` (default: the
    query positions) lets the keys be a different set, for checks."""
    sc = scale_in_dtype(q, scale)
    s = torch.matmul((q * sc).float(), k.float().transpose(-1, -2))
    pk = positions if kv_positions is None else kv_positions
    keep = voxel_keep(positions, pk, radius)[:, None]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l.clamp(min=1e-30)
    return out.to(q.dtype)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("masked_flash")
        lib.m324_masked_flash.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.m324_masked_flash.restype = ctypes.c_int
        _lib = lib
    return _lib


def _forward(q, k, v, positions, radius: float, scale: float) -> torch.Tensor:
    """K7 on CUDA tensors (``scale`` already rounded to q's dtype)."""
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"K7 is self-attention over one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if d != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if positions.shape != (b, s, 3) or positions.dtype != torch.float32:
        raise ValueError(f"positions must be f32 {(b, s, 3)}, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the CUDA kernel takes a contiguous, 16-byte "
                             f"aligned {name}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _load().m324_masked_flash(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b * h, h, s, scale, float(radius) ** 2,
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_flash launch failed: CUDA error {rc}")
    masked_flash_attention.launches += 1
    return out


def masked_flash_attention(q, k, v, positions, *, radius: float,
                           scale: float | None = None) -> torch.Tensor:
    """Attention restricted to token pairs within ``radius`` in 3D.

    ``q, k, v``: ``(B, H, S, D)``; ``positions``: ``(B, S, 3)`` per-token
    voxel-cell mean positions (zeros for empty cells); ``scale`` defaults to
    ``1/sqrt(D)``. Returns ``(B, H, S, D)`` in q's dtype. CUDA: K7; CPU:
    :func:`masked_attention_reference`."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, positions, radius=radius,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _forward(q.contiguous(), k.contiguous(), v.contiguous(),
                    positions.float().contiguous(), radius,
                    scale_in_dtype(q, scale))


masked_flash_attention.launches = 0
