"""K2 (forward) and K5 (backward): head-folded short attention over
model-native ``(B, S, H*64)``.

:func:`folded_attention` is differentiable. A call that needs no gradient
(DINOv2, under ``torch.no_grad``) launches ``csrc/folded_fwd.cu`` without
the LSE output (``folded_attention.launches``): K1's Hopper forward under
K2's name, reading the ``(B, S, H*64)`` tensors as ``(B, H, S, 64)``
through strides, its keys split by K9's rule (:func:`~motion324_tpu_torch.ops.short_attention.
short_split_count`, a function of (Sq, Sk) alone: the call sites stay
unsplit). A call with an input that
requires grad multiplies q by the logit scale in q's dtype and runs
:class:`FoldedAttentionFn`: its forward launches the same kernel with the
per-head f32 LSE ``(B, Sq, H)`` (``folded_attention.lse_launches``), its
backward is :func:`folded_attention_bwd`, which launches K5
(``csrc/folded_bwd.cu``; ``folded_attention_bwd.launches``): K4's two passes
under K5's name, split by :func:`folded_bwd_plan` (K9's rules over the B*H
slices), with no atomics, so a call repeats bit for bit and a slice's bits
do not depend on the batch. On a CPU tensor every step computes its plain
version instead. q, k and v (and the backward's o and dO) are read through
their strides (the q/k/v views of a fused QKV projection go in without a
copy); outputs are contiguous ``(B, S, H*64)``, which K5 writes through
strides with no permute (:func:`folded_bwd_strides`).
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops.flash_attention import (
    _DTYPES, _load, _tickets, attention_reference,
    flash_attention_bwd_reference, hopper_launch, lse_strides, map_strides,
    scale_in_dtype)
from motion324_tpu_torch.ops.short_attention import (_BWD_ARGS, short_bwd_plan,
                                                     short_split_count)

__all__ = ["folded_attention", "folded_attention_reference",
           "folded_attention_bwd", "folded_attention_bwd_reference",
           "FoldedAttentionFn", "folded_bwd_plan", "folded_bwd_strides",
           "folded_fwd_strides"]


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The ``(B, H, S, D)`` view of a ``(B, S, H*D)`` tensor (head stride
    D, row stride the tensor's), as the kernels read it: no copy."""
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


def folded_fwd_strides(q, k, v, heads: int) -> list[int]:
    """The 15 (batch, head, row) strides in elements that K2 is handed, from
    the ``(B, S, H*64)`` tensors themselves (no view is made: each would
    cost host time on every call): q, k and v as ``(B, H, S, 64)`` (head
    stride 64, row stride the tensor's: ``3 H 64`` on the fused-QKV slices;
    a batch or row dimension of size 1 gets :func:`map_strides`'s stride),
    the output's, which is the contiguous ``(B, Sq, H*64)``, and the f32
    LSE ``(B, Sq, H)`` (:func:`lse_strides`), the layout K5 and
    :class:`FoldedAttentionFn` read. Raises on what the kernel does not
    take (:func:`_check`)."""
    _check(q, k, v, heads)
    b, sq, c = q.shape
    st = []
    for t in (q, k, v):
        bs, rs, _ = t.stride()
        n = t.shape[1]
        st += [bs if b > 1 else n * 64, 64, rs if n > 1 else 64]
    return st + [sq * c, 64, c] + lse_strides(b, heads, sq, heads_last=True)


def _forward(q, k, v, heads: int, scale: float, with_lse: bool):
    """``(out, lse or None)``: the kernel on CUDA, the plain version on CPU.
    out is contiguous ``(B, Sq, H*64)``, lse f32 ``(B, Sq, H)``. The kernel
    is launched through :func:`hopper_launch` with the strides of
    :func:`folded_fwd_strides` and no view (the short rows are bound by the
    host work); a bf16 call's keys are split by :func:`short_split_count`,
    which keeps every call site unsplit."""
    if q.device.type == "cpu":
        out = folded_attention_reference(q, k, v, heads=heads, scale=scale,
                                         with_lse=with_lse)
        return out if with_lse else (out, None)
    strides = folded_fwd_strides(q, k, v, heads)
    dev = q.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _forward(q, k, v, heads, scale, with_lse)
    b, sq, c = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, c), dtype=q.dtype, device=dev)
    n_split = short_split_count(sq, sk) if q.dtype == torch.bfloat16 else 1
    lse = hopper_launch("folded_fwd", folded_attention, q, k, v, out, strides,
                        b, heads, sq, sk, n_split, scale, with_lse,
                        (b, sq, heads))
    return out, lse


def folded_bwd_plan(b: int, heads: int, sq: int, sk: int,
                    dtype: torch.dtype) -> tuple[int, int, int, int]:
    """``(n_split, dkv_split, workspace floats, tickets)`` of a K5 call over
    ``b`` images of ``heads`` heads: the K9 backward's plan
    (:func:`~motion324_tpu_torch.ops.short_attention.short_bwd_plan`) over
    its ``b * heads`` slices, since K5 runs the same two passes. The local
    layers (324 x 324) and the ragged rows run unsplit."""
    return short_bwd_plan(b * heads, sq, sk, dtype)


def folded_bwd_strides(q, k, v, o, do, lse, heads: int) -> list[int]:
    """The 27 (batch, head, row) strides in elements that K5 is handed: q,
    k, v, o and dO as ``(B, H, S, 64)`` views of their ``(B, S, H*64)``
    layout (head stride 64, row stride the view's, ``3 H 64`` on the
    fused-QKV slices; :func:`map_strides`, which refuses what a tensor map
    does not take), the contiguous f32 lse ``(B, Sq, H)`` (batch ``Sq H``,
    head 1, row ``H``), then the contiguous ``(B, S, H*64)`` dq, dk and dv
    the wrapper allocates."""
    st = []
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do)):
        st += map_strides(name, _heads_first(t, heads))
    b, sq, c = q.shape
    sk = k.shape[1]
    return st + lse_strides(b, heads, sq, heads_last=True) + [
        sq * c, 64, c, sk * c, 64, c, sk * c, 64, c]


def folded_attention_bwd(q, k, v, o, lse, do, *, heads: int):
    """Gradients ``(dq, dk, dv)``, contiguous ``(B, S, H*64)``, with respect
    to the pre-scaled q, k and v, from the forward's ``o`` and per-head f32
    ``lse`` ``(B, Sq, H)``. CUDA: K5, split by :func:`folded_bwd_plan`; CPU:
    :func:`folded_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return folded_attention_bwd_reference(q, k, v, o, lse, do, heads=heads,
                                              scale=1.0)
    _check(q, k, v, heads)
    b, sq, c = q.shape
    sk = k.shape[1]
    do = do.contiguous()
    dev = q.device
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype or do.device != dev or o.device != dev:
        raise ValueError("dO and O must have q's shape, dtype and device")
    if lse.shape != (b, sq, heads) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != dev:
        raise ValueError(f"lse must be contiguous f32 {(b, sq, heads)} on "
                         f"q's device")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return folded_attention_bwd(q, k, v, o, lse, do, heads=heads)
    strides = folded_bwd_strides(q, k, v, o, do, lse, heads)
    n_split, dkv_split, floats, n_tickets = folded_bwd_plan(b, heads, sq, sk,
                                                            q.dtype)
    dq = torch.empty((b, sq, c), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, c), dtype=q.dtype, device=dev)
    dv = torch.empty((b, sk, c), dtype=q.dtype, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets = _tickets(dev, stream, n_tickets) if n_tickets else None
    work = (torch.empty(floats, dtype=torch.float32, device=dev)
            if floats else None)
    rc = _load("folded_bwd", _BWD_ARGS).m324_folded_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if work is None else work.data_ptr(), floats,
        None if tickets is None else tickets.data_ptr(),
        0 if tickets is None else tickets.numel(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, heads, sq, sk,
        (ctypes.c_longlong * 27)(*strides), n_split, dkv_split,
        _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"folded_bwd launch failed: error {rc} (CUDA error "
                           f"below 900; 900 no cuTensorMapEncodeTiled; 901 a "
                           f"bad split; 902 too few tickets; 903 too small a "
                           f"workspace; 1000 + the driver's tensor-map error)")
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
