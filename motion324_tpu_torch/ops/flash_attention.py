"""K1 (forward) and K3 / K4 (backward): flash attention over ``(B, H, S, 64)``.

:func:`flash_attention` is differentiable. A call that needs no gradient
launches the forward kernel ``csrc/flash_fwd.cu`` (counted in
``flash_attention.launches``). A call with an input that requires grad
multiplies q by the logit scale in q's dtype (autograd carries ``dq * scale``)
and runs :class:`FlashAttentionFn` on the scaled q: its forward launches the
same kernel with the f32 log-sum-exp output (``flash_attention.lse_launches``)
and saves ``(q, k, v, o, lse)``; its backward is :func:`flash_attention_bwd`,
which launches K3 for KV <= 4096 and K4 beyond (``csrc/flash_bwd.cu``;
``flash_attention_bwd.fused_launches`` and ``.two_pass_launches``). On a CPU
tensor every step computes its plain version instead.
"""

from __future__ import annotations

import ctypes
import math

import torch

from motion324_tpu_torch.ops import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttentionFn", "FUSED_BWD_MAX_KV"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_libs: dict[str, ctypes.CDLL] = {}

# KV lengths up to this take the fused backward (K3), longer ones the
# two-pass backward (K4), as in the JAX package
FUSED_BWD_MAX_KV = 4096


def scale_in_dtype(q: torch.Tensor, scale: float | None) -> float:
    """The logit scale (default ``1/sqrt(D)``) rounded to q's dtype, as it is
    folded into q."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return float(torch.tensor(scale, dtype=q.dtype).item())


def attention_reference(q, k, v, scale: float, with_lse: bool = False):
    """The kernels' math in plain PyTorch over ``(..., S, D)``: q pre-scaled
    in its own dtype, f32 logits, unnormalised ``exp(s - max)`` rounded to
    v's dtype for the second product, f32 sums, division last. With
    ``with_lse`` also returns the f32 log-sum-exp of each row, ``(..., Sq)``."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


def flash_attention_reference(q, k, v, *, scale: float | None = None,
                              with_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention`. With ``with_lse``,
    returns ``(out, lse)`` as the forward kernel's LSE variant does, lse f32
    ``(B*H, Sq)``."""
    out = attention_reference(q, k, v, scale_in_dtype(q, scale), with_lse)
    if not with_lse:
        return out
    return out[0], out[1].reshape(-1, q.shape[-2])


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale: float | None = None):
    """Plain PyTorch version of the backward kernels over ``(..., S, D)``.

    ``lse`` holds ``q.shape[:-1]`` values (any shape of that size). The
    kernels work on q multiplied by ``scale`` in q's dtype: P from
    ``exp(s - lse)`` in f32, ``delta = rowsum(dO * O)`` in f32, P rounded to
    dO's dtype for dV, dS rounded to q's dtype for dQ and dK, f32 sums,
    outputs in the input dtypes. Returns ``(dq, dk, dv)``, dq with respect
    to the unscaled q (``scale=1.0`` when q is already scaled).
    """
    sc = scale_in_dtype(q, scale)
    qs = q * sc
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - lse.reshape(q.shape[:-1]).unsqueeze(-1))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dqs = torch.matmul(ds, k.float()).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    return (dqs * sc).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _load(name: str, argtypes) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, f"m324_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, scale: float, with_lse: bool):
    """``(out, lse or None)``: the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        if not with_lse:
            return flash_attention_reference(q, k, v, scale=scale), None
        return flash_attention_reference(q, k, v, scale=scale, with_lse=True)
    _check(q, k, v)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _load("flash_fwd", _FWD_ARGS).m324_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, sq, k.shape[2],
            scale, _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    if with_lse:
        flash_attention.lse_launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients ``(dq, dk, dv)`` of attention over ``(B, H, S, 64)`` with
    respect to the pre-scaled q, k and v, from the forward's ``o`` and f32
    ``lse`` ``(B*H, Sq)``. CUDA: K3 when KV <= ``FUSED_BWD_MAX_KV``, else K4;
    CPU: :func:`flash_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)
    _check(q, k, v)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    do = do.contiguous()
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO and O must have q's shape and dtype")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b * h, sq)}")
    # delta = rowsum(dO * O) in f32, once, outside the kernels
    delta = (do.float() * o.float()).sum(dim=-1)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fused = sk <= FUSED_BWD_MAX_KV
    acc = None
    if fused and q.dtype == torch.float32:
        dq = torch.zeros_like(q)
        acc = dq
    else:
        dq = torch.empty_like(q)
        if fused:
            acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _load("flash_bwd", _BWD_ARGS).m324_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if acc is None else acc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, _DTYPES[q.dtype],
            int(fused), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {rc}")
    if fused:
        flash_attention_bwd.fused_launches += 1
    else:
        flash_attention_bwd.two_pass_launches += 1
    return dq, dk, dv


flash_attention_bwd.fused_launches = 0
flash_attention_bwd.two_pass_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention over ``(B, H, S, D)`` with q already multiplied by the logit
    scale; the forward saves the f32 LSE ``(B*H, Sq)`` for the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, 1.0, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do)


def flash_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Exact attention ``softmax(q k^T * scale) v`` over ``(B, H, S, D)``.

    Returns ``(B, H, Sq, D)`` in q's dtype. ``scale`` defaults to
    ``1/sqrt(D)``. Differentiable (see the module docstring).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    scale = scale_in_dtype(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q * scale, k, v)
    return _forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.lse_launches = 0
