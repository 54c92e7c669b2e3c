"""K1 and K6 (forward), K3 / K4 (backward): flash attention over
``(B, H, S, 64)``.

The forward takes one of two kernels by the KV length, with the JAX
package's rule (:func:`single_kv_route`): K6, ``csrc/flash_single_kv.cu``,
when the KV padded to its block fits one block of at most 1 024 keys (KV in
[1, 256] and [385, 1024]); K1, ``csrc/flash_fwd.cu``, the online softmax
over KV tiles, otherwise.

K1 reads q, k and v through their (batch, head, row) strides, so the
dispatcher's ``(B, S, H, 64)`` views go in as they are, and writes its
output in q's layout. In bf16 it cuts the keys of a call with few query
tiles into :func:`split_count` ranges, each a block of its own, and adds
the partial results in split order (:func:`flash_attention_split_reference`
is the plain version of that arithmetic). The count depends on (Sq, Sk)
alone, never on B*H, so a slice's output has the same bits at any batch.

:func:`flash_attention` is differentiable. A call that needs no gradient
launches the forward kernel (counted in ``flash_attention.launches`` for K1,
``flash_attention.single_kv_launches`` for K6). A call with an input that
requires grad multiplies q by the logit scale in q's dtype (autograd carries
``dq * scale``) and runs :class:`FlashAttentionFn` on the scaled q: its
forward launches the same kernel with the f32 log-sum-exp output
(``flash_attention.lse_launches``, ``.single_kv_lse_launches``) and saves
``(q, k, v, o, lse)``; its backward is :func:`flash_attention_bwd`, which
launches K3 for KV <= 4096 and K4 beyond (``csrc/flash_bwd.cu``;
``flash_attention_bwd.fused_launches`` and ``.two_pass_launches``). In bf16
K4's dq pass splits the keys by the same :func:`split_count` as K1 and adds
the f32 partials in split order (:func:`flash_attention_bwd_split_reference`),
so K4 too repeats bit for bit at any batch. On a CPU
tensor every step computes its plain version instead.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from motion324_tpu_torch.ops import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_split_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference",
           "flash_attention_bwd_split_reference", "FlashAttentionFn",
           "bwd_plan", "FUSED_BWD_MAX_KV", "SINGLE_KV_MAX", "single_kv_route",
           "split_count", "split_ranges"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_libs: dict[str, ctypes.CDLL] = {}

# KV lengths up to this take the fused backward (K3), longer ones the
# two-pass backward (K4), as in the JAX package
FUSED_BWD_MAX_KV = 4096
# the largest KV block of the single-KV forward (K6), and the KV block size
# the JAX package's flash forward aims at
SINGLE_KV_MAX = 1024
_KV_BLOCK_TARGET = 1024

# K1's tiles: 128 query rows (64 when Sq <= 64) and 128 keys. A call with
# fewer than SPLIT_MAX_Q_TILES query tiles cuts its keys so that each (batch,
# head) has about SPLIT_BLOCKS blocks: the shape encoder's 64 queries x
# 16 384 keys give 16 splits of 1 024 keys, 192 blocks at 12 heads. The
# kernel takes at most 16 splits (kMaxSplits in csrc/flash_fwd.cu)
K1_Q_TILE = 128
K1_KV_TILE = 128
SPLIT_MAX_Q_TILES = 8
SPLIT_BLOCKS = 16


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_kv_block(seq: int) -> int:
    """The JAX package's KV block (``_pick_block`` with granule 128): the
    largest pad-free 128-multiple divisor of the padded length in
    [max(128, target/2), target]; failing that, above the target, the
    largest pad-free 8-multiple divisor in (target, 2 target]; else the
    target, or below it the power of two (>= 128) that pads least. The
    divisor wins only where it pads no more than that fallback."""
    target = _KV_BLOCK_TARGET
    seq_g = _ceil_to(seq, 128)
    exact = 0
    for d in range(max(128, target // 2), min(seq_g, target) + 1, 128):
        if seq_g % d == 0:
            exact = d
    if not exact and seq > target:
        seq_8 = _ceil_to(seq, 8)
        for d in range(_ceil_to(target + 8, 8), min(seq_8, 2 * target) + 1, 8):
            if seq_8 % d == 0:
                exact = d
    if seq >= target:
        fall = target
    else:
        fall, b = 128, 256
        while b <= target:
            if _ceil_to(seq, b) <= _ceil_to(seq, fall):
                fall = b
            b *= 2
    if exact and _ceil_to(seq, exact) <= _ceil_to(seq, fall):
        return exact
    return fall


@functools.lru_cache(maxsize=None)
def single_kv_route(sk: int) -> bool:
    """Whether a flash call over ``sk`` keys takes K6: the KV padded to its
    block is that one block, of at most ``SINGLE_KV_MAX`` keys, as in the
    JAX package's ``_fwd``. True for KV in [1, 256] and [385, 1024]; KV in
    [257, 384] streams through K1 in blocks of 128, as does KV > 1024."""
    bkv = _pick_kv_block(sk)
    return _ceil_to(sk, bkv) <= min(bkv, SINGLE_KV_MAX)


def scale_in_dtype(q: torch.Tensor, scale: float | None) -> float:
    """The logit scale (default ``1/sqrt(D)``) rounded to q's dtype, as it is
    folded into q."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _rounded(float(scale), q.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype).item())


def attention_reference(q, k, v, scale: float, with_lse: bool = False):
    """The kernels' math in plain PyTorch over ``(..., S, D)``: q pre-scaled
    in its own dtype, f32 logits, unnormalised ``exp(s - max)`` rounded to
    v's dtype for the second product, f32 sums, division last. With
    ``with_lse`` also returns the f32 log-sum-exp of each row, ``(..., Sq)``.

    The max is the row's max over all keys, so this is exactly K6's
    arithmetic (one max before any exp, no rescale); K1 and K2 compute the
    same function with a running max over KV tiles."""
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


@functools.lru_cache(maxsize=None)
def split_count(sq: int, sk: int) -> int:
    """K1's number of key ranges for Sq queries over Sk keys: 1 at
    ``SPLIT_MAX_Q_TILES`` query tiles or more (the long self-attention
    rows), else about ``SPLIT_BLOCKS`` blocks per (batch, head), each range
    whole 128-key tiles and none empty. A function of (Sq, Sk) only."""
    q_tiles = -(-sq // K1_Q_TILE)
    if q_tiles >= SPLIT_MAX_Q_TILES:
        return 1
    tiles = -(-sk // K1_KV_TILE)
    want = max(1, min(tiles, -(-SPLIT_BLOCKS // q_tiles)))
    return -(-tiles // -(-tiles // want))


def split_ranges(sk: int, n_split: int) -> list[tuple[int, int]]:
    """The ``[begin, end)`` key range of each of K1's ``n_split`` splits:
    ``ceil(tiles / n_split)`` whole 128-key tiles each, the last one ragged
    (the kernel computes the same)."""
    per = -(-(-(-sk // K1_KV_TILE)) // n_split) * K1_KV_TILE
    return [(i * per, min(sk, (i + 1) * per)) for i in range(n_split)]


def flash_attention_split_reference(q, k, v, n_split: int, *,
                                    scale: float | None = None):
    """Plain PyTorch version of K1's split-and-combine over ``(..., S, D)``:
    each key range of :func:`split_ranges` gives a normalised partial output
    and LSE in f32 (:func:`attention_reference` on that range, before the
    rounding to q's dtype), and the splits are added in split order:
    ``lse = log sum_i exp(lse_i)``, ``O = sum_i exp(lse_i - lse) O_i``,
    rounded to q's dtype. Returns ``(out, lse)``, lse f32 ``(..., Sq)``."""
    sc = scale_in_dtype(q, scale)
    parts = []
    for a, b in split_ranges(k.shape[-2], n_split):
        kk, vv = k[..., a:b, :], v[..., a:b, :]
        s = torch.matmul((q * sc).float(), kk.float().transpose(-1, -2))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vv.float()) / l
        parts.append((o, (m + torch.log(l)).squeeze(-1)))
    lses = torch.stack([lse for _, lse in parts])
    mx = lses.amax(dim=0)
    total = torch.zeros_like(mx)
    for lse in lses:
        total = total + torch.exp(lse - mx)
    lse = mx + torch.log(total)
    out = torch.zeros_like(parts[0][0])
    for o, part_lse in parts:
        out = out + torch.exp(part_lse - lse).unsqueeze(-1) * o
    return out.to(q.dtype), lse


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


def flash_attention_bwd_split_reference(q, k, v, o, lse, do, n_split: int,
                                        scale: float | None = None):
    """Plain PyTorch version of K4's split dq pass over ``(..., S, D)``: the
    dq of each key range of :func:`split_ranges` as an f32 partial (the
    arithmetic of :func:`flash_attention_bwd_reference` on that range),
    added in split order, then rounded to q's dtype; dk and dv as
    :func:`flash_attention_bwd_reference` computes them. Returns
    ``(dq, dk, dv)``."""
    sc = scale_in_dtype(q, scale)
    qs = q * sc
    l = lse.reshape(q.shape[:-1]).unsqueeze(-1)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dq = None
    for a, b in split_ranges(k.shape[-2], n_split):
        kk, vv = k[..., a:b, :], v[..., a:b, :]
        p = torch.exp(torch.matmul(qs.float(), kk.float().transpose(-1, -2)) - l)
        dp = torch.matmul(do.float(), vv.float().transpose(-1, -2))
        ds = (p * (dp - delta)).to(q.dtype).float()
        part = torch.matmul(ds, kk.float())
        dq = part if dq is None else dq + part
    _, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=scale)
    return (dq.to(q.dtype) * sc).to(q.dtype), dk, dv


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
_K1_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


def _check_shapes(q, k, v):
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
    if k.shape[2] == 0 or q.shape[2] == 0:
        raise ValueError("empty sequence")


def _check(q, k, v) -> list[int]:
    """What K1 takes: (B, H, S, 64) q/k/v of one dtype on one device, each
    with unit stride in the head dim, 16-byte-aligned (batch, head, row)
    strides and a 16-byte-aligned base: contiguous tensors and the
    dispatcher's transposed ``(B, S, H, 64)`` views alike. Returns the
    (batch, head, row) strides of q, k and v in elements
    (:func:`map_strides`). Each call of K1 pays for this on the host, so it
    reads each attribute once."""
    qs, ks, vs = q.shape, k.shape, v.shape
    if (len(qs) != 4 or len(ks) != 4 or ks != vs or qs[:2] != ks[:2]
            or qs[3] != 64 or ks[3] != 64 or qs[2] == 0 or ks[2] == 0
            or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype or k.device != q.device
            or v.device != q.device):
        _check_shapes(q, k, v)    # raises, saying what is wrong
    return (map_strides("q", q) + map_strides("k", k)
            + map_strides("v", v))


def map_strides(name: str, t: torch.Tensor) -> list[int]:
    """The (batch, head, row) strides in elements of a (B, H, S, 64) tensor
    that a Hopper kernel reads through a tensor map: unit stride in the head
    dim, 16-byte-aligned strides and base, else ValueError. A dimension of
    size 1 gets a stride that a tensor map takes (it is never stepped)."""
    st = t.stride()
    shape = t.shape
    if st[3] != 1:
        raise ValueError(f"the CUDA kernel takes {name} with unit stride "
                         f"in the head dim, got strides {st}")
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or (st[0] % per16 and shape[0] > 1) \
            or (st[1] % per16 and shape[1] > 1) \
            or (st[2] % per16 and shape[2] > 1):
        raise ValueError(f"{name}'s base or rows are not 16-byte aligned "
                         f"(strides {st})")
    pad = shape[2] * 64
    return [st[0] if shape[0] > 1 else pad, st[1] if shape[1] > 1 else pad,
            st[2] if shape[2] > 1 else pad]


def _check_contiguous(q, k, v):
    """What K6 and the backward kernels take: contiguous, aligned
    (B, H, S, 64) q/k/v."""
    _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_k1(q, k, v, scale: float, with_lse: bool):
    """K1 on CUDA tensors, whatever the KV length: ``(out, lse or None)``,
    out (B, H, Sq, 64) laid out heads-last where q is, else contiguous. bf16
    calls split their keys by :func:`split_count`."""
    return hopper_forward("flash_fwd", flash_attention, q, k, v, scale,
                          with_lse, split_count)


def hopper_forward(name: str, counter, q, k, v, scale: float, with_lse: bool,
                   split):
    """Launch the Hopper forward kernel of library ``name`` (``"flash_fwd"``:
    K1; ``"short_fwd"``: the K9 forward, the same kernel under K9's name) on
    CUDA tensors: ``(out, lse or None)``, out (B, H, Sq, 64) laid out
    heads-last where q is, else contiguous; a bf16 call cuts its keys into
    ``split(Sq, Sk)`` ranges (f32: 1). Adds one to ``counter.launches`` or
    ``counter.lse_launches``. The host work here is part of each call's time
    at the short rows, so it is kept lean."""
    strides = _check(q, k, v)
    dev = q.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return hopper_forward(name, counter, q, k, v, scale, with_lse,
                                  split)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    n_split = split(sq, sk) if q.dtype == torch.bfloat16 else 1
    if q.stride(1) < q.stride(2):
        # a (B, S, H, 64) view: the output keeps that layout, so that the
        # dispatcher's transpose back is contiguous
        out = torch.empty((b, sq, h, 64), dtype=q.dtype, device=dev).transpose(1, 2)
        strides += [sq * h * 64, 64, h * 64]
    else:
        out = torch.empty((b, h, sq, 64), dtype=q.dtype, device=dev)
        strides += [h * sq * 64, sq * 64, 64]
    # one f32 buffer (one allocation): the LSE, then for a split call the
    # partial LSEs and outputs, each part at a 16-byte boundary (the kernel
    # reads the partial outputs as float4); the LSE is a view, so the
    # workspace lives as long as it does
    rows = b * h * sq
    n_lse = -(-rows // 4) * 4 if with_lse else 0
    n_part = n_split * rows if n_split > 1 else 0
    n_plse = -(-n_part // 4) * 4
    buf = (torch.empty(n_lse + n_plse + 64 * n_part, dtype=torch.float32,
                       device=dev) if n_lse + n_part else None)
    base = 0 if buf is None else buf.data_ptr()
    lse = buf[:rows].view(b * h, sq) if with_lse else None
    part_lse = base + 4 * n_lse if n_part else None
    part_o = base + 4 * (n_lse + n_plse) if n_part else None
    # the current stream's handle without a Stream object (5 us less host
    # time per call on the H100's machine)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    # one ticket per (query tile, slice); a tile is 128 rows, or all of
    # Sq <= 64 (a call over Sk <= 64 keys, whose tiles are 64 rows, is
    # never split)
    tickets = (_tickets(dev, stream, -(-sq // K1_Q_TILE) * b * h)
               if n_split > 1 else None)
    rc = getattr(_load(name, _K1_ARGS), "m324_" + name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        base if with_lse else None, part_o, part_lse,
        None if tickets is None else tickets.data_ptr(),
        0 if tickets is None else tickets.numel(), b, h, sq, sk,
        (ctypes.c_longlong * 12)(*strides), n_split, scale, _DTYPES[q.dtype],
        stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: error {rc} (CUDA error "
                           f"below 900; 900 no cuTensorMapEncodeTiled; 901 an "
                           f"empty split; 902 too few tickets; 1000 + the "
                           f"driver's tensor-map error)")
    if with_lse:
        counter.lse_launches += 1
    else:
        counter.launches += 1
    return out, lse


# the split calls' tickets: one zeroed int32 per (query tile, slice), by
# (device, stream), since a call leaves them zeroed for the next call on its
# stream only
_TICKETS: dict = {}


def _tickets(dev, stream, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tickets for split calls on ``stream`` (K1,
    K4, K9)."""
    buf = _TICKETS.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = _TICKETS[(dev.index, stream)] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev)
    return buf


def _forward_single_kv(q, k, v, scale: float, with_lse: bool):
    """K6 on CUDA tensors, as contiguous (B*H, S, 64) slices (the
    dispatcher's views are copied); raises past ``SINGLE_KV_MAX`` keys."""
    if k.shape[2] > SINGLE_KV_MAX:
        raise ValueError(f"the single-KV kernel takes at most {SINGLE_KV_MAX} "
                         f"keys, got {k.shape[2]}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_contiguous(q, k, v)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _load("flash_single_kv", _FWD_ARGS).m324_flash_single_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, sq, k.shape[2],
            scale, _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_single_kv launch failed: CUDA error {rc}")
    if with_lse:
        flash_attention.single_kv_lse_launches += 1
    else:
        flash_attention.single_kv_launches += 1
    return out, lse


def _forward(q, k, v, scale: float, with_lse: bool):
    """``(out, lse or None)``: on CUDA, K6 where :func:`single_kv_route`
    takes it, else K1; on CPU the plain version."""
    if q.device.type == "cpu":
        if not with_lse:
            return flash_attention_reference(q, k, v, scale=scale), None
        return flash_attention_reference(q, k, v, scale=scale, with_lse=True)
    if single_kv_route(k.shape[2]):
        return _forward_single_kv(q, k, v, scale, with_lse)
    return _forward_k1(q, k, v, scale, with_lse)


def flash_attention_bwd(q, k, v, o, lse, do):
    """Gradients ``(dq, dk, dv)`` of attention over ``(B, H, S, 64)`` with
    respect to the pre-scaled q, k and v, from the forward's ``o`` and f32
    ``lse`` ``(B*H, Sq)``. CUDA: K3 when KV <= ``FUSED_BWD_MAX_KV``, else K4,
    whose dq pass splits the keys of a bf16 call by :func:`split_count`
    (:func:`flash_attention_bwd_split_reference` is its plain version);
    CPU: :func:`flash_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)
    _check_contiguous(q, k, v)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    do = do.contiguous()
    o = o.contiguous()
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype:
        raise ValueError("dO and O must have q's shape and dtype")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b * h, sq)}")
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("dO and O must be 16-byte aligned")
    dev = q.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return flash_attention_bwd(q, k, v, o, lse, do)
    fused, n_split, work_floats = bwd_plan(b * h, sq, sk, q.dtype)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets = (_tickets(dev, stream, -(-sq // K1_Q_TILE) * b * h)
               if n_split > 1 else None)
    work = torch.empty(work_floats, dtype=torch.float32, device=dev)
    rc = _load("flash_bwd", _BWD_ARGS).m324_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), work.data_ptr(), work.numel(),
        None if tickets is None else tickets.data_ptr(),
        0 if tickets is None else tickets.numel(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, n_split,
        _DTYPES[q.dtype], int(fused), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed: error {rc} (CUDA error "
                           f"below 900; 900 no cuTensorMapEncodeTiled; 901 a "
                           f"bad split; 902 too few tickets; 903 too small a "
                           f"workspace; 1000 + the driver's tensor-map error)")
    if fused:
        flash_attention_bwd.fused_launches += 1
    else:
        flash_attention_bwd.two_pass_launches += 1
    return dq, dk, dv


def bwd_plan(bh: int, sq: int, sk: int,
             dtype: torch.dtype) -> tuple[bool, int, int]:
    """``(fused, n_split, workspace floats)`` of a K3 / K4 call over ``bh``
    (batch, head) slices: K3 for KV <= ``FUSED_BWD_MAX_KV``; a bf16 K4
    splits its dq pass by :func:`split_count` (a function of (Sq, Sk) only,
    never of ``bh``). The f32 workspace (``csrc/flash_bwd.cu``): bf16 keeps
    lse * log2(e) and delta in rows padded to 128, then K3's dq workspace or
    the split dq pass's partials; f32 keeps delta."""
    fused = sk <= FUSED_BWD_MAX_KV
    if dtype != torch.bfloat16:
        return fused, 1, bh * sq
    rows = bh * _ceil_to(sq, 128)
    if fused:
        return True, 1, rows * (2 + 64)
    n_split = split_count(sq, sk)
    return False, n_split, rows * (2 + (64 * n_split if n_split > 1 else 0))


flash_attention_bwd.fused_launches = 0
flash_attention_bwd.two_pass_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention over contiguous ``(B, H, S, D)`` with q already multiplied
    by the logit scale; the forward saves the f32 LSE ``(B*H, Sq)`` for the
    backward (K3 / K4 read contiguous tensors)."""

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
    ``1/sqrt(D)``. Differentiable (see the module docstring): a
    differentiated call runs on contiguous copies of its inputs, as the
    backward kernels take them.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    scale = scale_in_dtype(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply((q * scale).contiguous(), k.contiguous(),
                                      v.contiguous())
    return _forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.lse_launches = 0
flash_attention.single_kv_launches = 0
flash_attention.single_kv_lse_launches = 0
