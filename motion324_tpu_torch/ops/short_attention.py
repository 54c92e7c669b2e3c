"""K9 (forward and backward): short attention over ``(B, H, S, 64)``, the
``"short_legacy"`` attention backend.

:func:`short_attention` is differentiable. A call that needs no gradient
launches ``csrc/short_fwd.cu`` without the LSE output
(``short_attention.launches``); the logit scale, rounded to q's dtype, is
folded into q as the kernel loads it. A call with an input that requires
grad multiplies q by the scale in q's dtype (autograd carries
``dq * scale``) and runs :class:`ShortAttentionFn` on the scaled q: its
forward launches the same kernel with the compact f32 LSE ``(B*H, Sq)``
(``short_attention.lse_launches``) and saves ``(q, k, v, o, lse)``; its
backward is :func:`short_attention_bwd`, which launches ``csrc/short_bwd.cu``
(``short_attention_bwd.launches``). On a CPU tensor every step computes its
plain version instead, at any head dim.

The kernels read q, k, v, o and dO through their (batch, head, row)
strides, so the legacy route's ``(B, S, H, 64)`` views go in without a
copy. The forward is K1's Hopper kernel under K9's name; in bf16 it cuts the
keys of a call of one query tile into :func:`short_split_count` ranges and
adds the partial results in split order
(:func:`short_attention_split_reference`). The backward is K4's two passes
under K9's name: the dq pass splits the keys by the same rule, and the
dk/dv pass cuts the query tiles of a call with many query tiles over few
key tiles (the decoder's 4 096 points over 64 mesh tokens) into
:func:`short_dkv_split_count` ranges, with the f32 partials of both added in
split order (:func:`short_attention_bwd_split_reference`). Both counts
depend on (Sq, Sk) alone, never on B*H, and no atomics touch the data, so a
slice's bits do not depend on the batch and a call repeats bit for bit.

The semantics are those of the JAX package's ``short_attention``: q
pre-scaled in its own dtype, keys past the KV length masked, one softmax
over all keys with P rounded to v's dtype before P V and the division last,
the LSE in f32; the backward's P in f32, P rounded to dO's dtype for dV, dS
rounded to q's dtype for dQ and dK. The TPU kernel pads queries to 16s and
keys to 128s and takes the softmax in one pass; the CUDA kernels mask
instead and round P against a running max over 128-key tiles, as K1 does.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops.flash_attention import (
    K1_Q_TILE, SPLIT_BLOCKS, SPLIT_MAX_Q_TILES, _DTYPES, _check, _load,
    _tickets, attention_reference, flash_attention_bwd_reference,
    flash_attention_bwd_split_reference, flash_attention_split_reference,
    hopper_forward, map_strides, scale_in_dtype, split_count)

__all__ = ["short_attention", "short_attention_reference",
           "short_attention_split_reference", "short_attention_bwd",
           "short_attention_bwd_reference",
           "short_attention_bwd_split_reference", "ShortAttentionFn",
           "short_split_count", "short_dkv_split_count", "dkv_ranges",
           "short_bwd_plan"]

_BWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])

# the backward's dk/dv blocks: 64 keys per consumer warpgroup, query tiles of
# 64 rows; a split of the query tiles holds at least DKV_MIN_TILES of them.
# Each split adds an f32 partial dk and dv per key block, written and read
# once more: at the training decoder (288 slices x 4 096 x 64) an H100 ran
# the backward fastest with 2 splits of 32 tiles, 3% faster than unsplit
# and 7% faster than 8 splits of 8 (chip_smoke.py's K9 phase times 1, 2, 4
# and 8)
DKV_Q_TILE = 64
DKV_MIN_TILES = 32
# the rows of the backward's lse / delta workspace are padded to this
_PAD_ROWS = 128


def short_split_count(sq: int, sk: int) -> int:
    """The K9 forward's (and its backward's dq pass's) number of key ranges
    for Sq queries over Sk keys: K1's :func:`split_count` for a call of one
    query tile (Sq <= 128: the shape encoder's 64 queries over 4 096 or
    16 384 keys give 16 ranges), else 1. K1's rule would cut the local
    layers' 324 x 324 into 3 ranges, whose f32 partials cost more bytes than
    their 432 blocks (144 slices) gain. A function of (Sq, Sk) only."""
    return split_count(sq, sk) if sq <= K1_Q_TILE else 1


def bwd_consumers(sq: int, sk: int) -> int:
    """Consumer warpgroups of a K9 / K4 dk/dv block (64 keys each) and dq
    pass block (64 query rows each): one when Sq <= 64 or Sk <= 64, else
    two (``consumers`` in csrc/hopper_bwd.cuh)."""
    return 1 if sq <= 64 or sk <= 64 else 2


def short_dkv_split_count(sq: int, sk: int) -> int:
    """The K9 backward's number of query ranges in its dk/dv pass: 1 unless
    the call has fewer than ``SPLIT_MAX_Q_TILES`` key blocks and at least
    twice ``DKV_MIN_TILES`` query tiles of 64 rows; then up to
    ``SPLIT_BLOCKS`` blocks per (batch, head), at least ``DKV_MIN_TILES``
    whole query tiles each and none empty. The decoder's 4 096 points over
    64 mesh tokens (one key block) give 2 ranges of 32 tiles, 576 blocks at
    288 slices; the global, local, shape-encoder and point-block rows stay
    unsplit. A function of (Sq, Sk) only."""
    q_tiles = -(-sq // DKV_Q_TILE)
    key_blocks = -(-sk // (64 * bwd_consumers(sq, sk)))
    if key_blocks >= SPLIT_MAX_Q_TILES:
        return 1
    want = min(-(-SPLIT_BLOCKS // key_blocks), q_tiles // DKV_MIN_TILES)
    if want <= 1:
        return 1
    return -(-q_tiles // -(-q_tiles // want))


def dkv_ranges(sq: int, n_split: int) -> list[tuple[int, int]]:
    """The ``[begin, end)`` query range of each of the dk/dv pass's
    ``n_split`` splits: ``ceil(tiles / n_split)`` whole 64-row tiles each,
    the last one ragged (the kernel computes the same)."""
    per = -(-(-(-sq // DKV_Q_TILE)) // n_split) * DKV_Q_TILE
    return [(i * per, min(sq, (i + 1) * per)) for i in range(n_split)]


def short_bwd_plan(bh: int, sq: int, sk: int,
                   dtype: torch.dtype) -> tuple[int, int, int, int]:
    """``(n_split, dkv_split, workspace floats, tickets)`` of a K9 backward
    over ``bh`` (batch, head) slices: bf16 splits the dq pass's keys by
    :func:`short_split_count` and the dk/dv pass's query tiles by
    :func:`short_dkv_split_count`. The f32 workspace
    (``two_pass_floats`` in csrc/hopper_bwd.cuh): lse * log2(e) and delta in
    rows padded to 128, the dq split's partials (one f32 dq per split), the
    dk/dv split's partials (one f32 dk and dv per split, over the keys
    padded to the dk/dv blocks); the tickets, one per (slice, tile) of a
    split pass. f32 calls are never split and need neither."""
    if dtype != torch.bfloat16:
        return 1, 1, 0, 0
    n_split = short_split_count(sq, sk)
    dkv_split = short_dkv_split_count(sq, sk)
    rows = bh * -(-sq // _PAD_ROWS) * _PAD_ROWS
    floats = 2 * rows
    tickets = 0
    if n_split > 1:
        floats += n_split * rows * 64
        q_rows = 64 * bwd_consumers(sq, sk)
        tickets = bh * -(-sq // q_rows)
    if dkv_split > 1:
        keys = 64 * bwd_consumers(sq, sk)
        floats += dkv_split * bh * -(-sk // keys) * keys * 2 * 64
        tickets = max(tickets, bh * -(-sk // keys))
    return n_split, dkv_split, floats, tickets


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


def short_attention_split_reference(q, k, v, n_split: int, *,
                                    scale: float | None = None):
    """Plain PyTorch version of the K9 forward's split-and-combine over
    ``(..., S, D)``: K1's (:func:`~motion324_tpu_torch.ops.flash_attention.
    flash_attention_split_reference`), with the LSE compact,
    ``(prod(leading dims), Sq)``. Returns ``(out, lse)``."""
    out, lse = flash_attention_split_reference(q, k, v, n_split, scale=scale)
    return out, lse.reshape(-1, q.shape[-2])


def short_attention_bwd_reference(q, k, v, o, lse, do):
    """Plain PyTorch version of the K9 backward over ``(..., S, D)`` for q
    already multiplied by the logit scale: P = exp(q k^T - lse) in f32,
    ``delta = rowsum(dO * O)`` in f32, P rounded to dO's dtype for dV, dS
    rounded to q's dtype for dQ and dK, f32 sums. ``lse`` holds
    ``q.shape[:-1]`` values. Returns ``(dq, dk, dv)`` with respect to the
    scaled q, k and v."""
    return flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)


def short_attention_bwd_split_reference(q, k, v, o, lse, do, n_split: int,
                                        dkv_split: int):
    """Plain PyTorch version of the K9 backward's split passes over
    ``(..., S, D)``, q already scaled: dq as K4's split dq pass computes it
    (the f32 partial of each of ``n_split`` key ranges, added in split
    order, then rounded); dk and dv as f32 partials over each query range
    of :func:`dkv_ranges` (the arithmetic of
    :func:`short_attention_bwd_reference` on those rows), added in split
    order, then rounded. Returns ``(dq, dk, dv)``."""
    dq = flash_attention_bwd_split_reference(q, k, v, o, lse, do, n_split,
                                             scale=1.0)[0]
    l = lse.reshape(q.shape[:-1]).unsqueeze(-1)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dk = dv = None
    for a, b in dkv_ranges(q.shape[-2], dkv_split):
        qq, dd = q[..., a:b, :].float(), do[..., a:b, :]
        p = torch.exp(torch.matmul(qq, k.float().transpose(-1, -2))
                      - l[..., a:b, :])
        part_v = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                              dd.float())
        dp = torch.matmul(dd.float(), v.float().transpose(-1, -2))
        ds = (p * (dp - delta[..., a:b, :])).to(q.dtype).float()
        part_k = torch.matmul(ds.transpose(-1, -2), qq)
        dk = part_k if dk is None else dk + part_k
        dv = part_v if dv is None else dv + part_v
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, scale: float, with_lse: bool):
    """``(out, lse or None)`` over ``(B, H, S, D)``: the kernel on CUDA
    (its keys split by :func:`short_split_count`), the plain version on
    CPU."""
    if q.device.type == "cpu":
        if not with_lse:
            return short_attention_reference(q, k, v, scale=scale), None
        return short_attention_reference(q, k, v, scale=scale, with_lse=True)
    return hopper_forward("short_fwd", short_attention, q, k, v, scale,
                          with_lse, short_split_count)


def short_attention_bwd(q, k, v, o, lse, do):
    """Gradients ``(dq, dk, dv)``, contiguous ``(B, H, S, 64)``, with respect
    to the pre-scaled q, k and v, from the forward's ``o`` and compact f32
    ``lse`` ``(B*H, Sq)``; q, k, v, o and dO of ``(B, H, S, 64)`` read
    through their strides. CUDA: the K9 backward, split by
    :func:`short_bwd_plan`; CPU: :func:`short_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return short_attention_bwd_reference(q, k, v, o, lse, do)
    dev = q.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return short_attention_bwd(q, k, v, o, lse, do)
    b, h, sq, _ = q.shape
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype:
        raise ValueError("dO and O must have q's shape and dtype")
    if q.dtype == torch.float32:
        # the scalar checking kernels take (B*H, S, 64) slices: batch 1
        q, k, v, o, do = (x.reshape(1, b * h, *x.shape[2:])
                          for x in (q, k, v, o, do))
    strides = (_check(q, k, v) + map_strides("o", o) + map_strides("dO", do))
    sk = k.shape[2]
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b * h, sq)}")
    n_split, dkv_split, floats, n_tickets = short_bwd_plan(b * h, sq, sk,
                                                           q.dtype)
    dq = torch.empty((b, h, sq, 64), dtype=q.dtype, device=dev)
    dk = torch.empty((b, h, sk, 64), dtype=q.dtype, device=dev)
    dv = torch.empty((b, h, sk, 64), dtype=q.dtype, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets = _tickets(dev, stream, n_tickets) if n_tickets else None
    work = (torch.empty(floats, dtype=torch.float32, device=dev)
            if floats else None)
    rc = _load("short_bwd", _BWD_ARGS).m324_short_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if work is None else work.data_ptr(), floats,
        None if tickets is None else tickets.data_ptr(),
        0 if tickets is None else tickets.numel(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), q.shape[0], q.shape[1], sq, sk,
        (ctypes.c_longlong * 15)(*strides), n_split, dkv_split,
        _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"short_bwd launch failed: error {rc} (CUDA error "
                           f"below 900; 900 no cuTensorMapEncodeTiled; 901 a "
                           f"bad split; 902 too few tickets; 903 too small a "
                           f"workspace; 904 an f32 call over batches; 1000 + "
                           f"the driver's tensor-map error)")
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_bwd.launches = 0


class ShortAttentionFn(torch.autograd.Function):
    """Short attention over ``(B, H, S, D)`` with q already multiplied by the
    logit scale; the forward saves the compact f32 LSE ``(B*H, Sq)`` for the
    backward."""

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

    Returns ``(B, H, Sq, D)`` in q's dtype, laid out heads-last on CUDA
    where q is. ``scale`` defaults to ``1/sqrt(D)``. Differentiable (see the
    module docstring); a CUDA tensor with D other than 64 raises.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"short_attention takes (B, H, S, D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    scale = scale_in_dtype(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return ShortAttentionFn.apply(q * scale, k, v)
    return _forward(q, k, v, scale, with_lse=False)[0]


short_attention.launches = 0
short_attention.lse_launches = 0
