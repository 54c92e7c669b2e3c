"""K7: voxel-masked flash attention (turbo multiview), ``csrc/masked_flash.cu``.

Replaces the TPU kernel ``_fwd_kernel`` of
``motion324_tpu/ops/masked_attention.py``: self-attention over ``(B, H, S,
D)`` restricted to the token pairs whose voxel-cell positions (``(B, S, 3)``,
shared by the heads) lie within ``radius``,

    d2 = |pq|^2 + |pk|^2 - 2 pq.pk < radius^2,

evaluated in f32 in that order (:func:`voxel_keep`). Masked logits are
-1e30; each real token keeps its own key, so no real row is fully masked.
Forward only: turbo texturing is inference.

In bf16 the kernel runs in two launches. A pre-pass evaluates the test once
per batch (not per head) and writes the mask bits and, per tile of
``MASK_TILE`` queries by ``MASK_TILE`` keys, whether the tile holds a kept
pair (:func:`masked_tile_list_reference` is its plain version). The main
loop, K1's Hopper forward under K7's name, visits for each query tile only
the key tiles so listed, in order, and masks each logit by its bit. That is
exact: a tile it skips holds no kept key of any of its rows
(:func:`masked_attention_tiled_reference` computes the same skipping in
plain PyTorch). q, k, v and the output go through their strides, so the
UNet's ``(B, S, H, 64)`` views need no copy. The f32 checking kernel tests
each pair itself.

:func:`masked_flash_attention` launches K7 on CUDA tensors (counted in
``masked_flash_attention.launches``) and computes
:func:`masked_attention_reference` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from motion324_tpu_torch.ops import _build
from motion324_tpu_torch.ops.flash_attention import (_empty_out, map_strides,
                                                     scale_in_dtype)

__all__ = ["masked_flash_attention", "masked_attention_reference",
           "masked_attention_tiled_reference", "masked_tile_list",
           "masked_tile_list_reference", "voxel_keep", "MASK_TILE"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None

# the pre-pass's tiles: 128 queries x 128 keys, the main loop's
MASK_TILE = 128


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


def masked_tile_list_reference(positions, radius: float,
                               tile: int = MASK_TILE):
    """The pre-pass's output in plain PyTorch, from :func:`voxel_keep`, for
    ``(B, S, 3)`` positions cut into ``T = ceil(S / tile)`` tiles:
    ``(bits, keep_tiles)``. ``bits`` int32 ``(B, T tile, T tile / 32)``: bit
    ``e`` of word ``w`` of row ``r`` set where query ``r`` keeps key
    ``32 w + e`` (rows and keys past S clear; the u32 words of the kernel,
    read as int32). ``keep_tiles`` bool ``(B, T, T)``: tile ``(qt, kt)``
    holds a kept pair. The list of key tiles that query tile ``qt`` visits
    is ``keep_tiles[b, qt].nonzero()``, in ascending order; it always holds
    ``qt``."""
    b, s, _ = positions.shape
    t = -(-s // tile)
    keep = torch.zeros((b, t * tile, t * tile), dtype=torch.bool,
                       device=positions.device)
    keep[:, :s, :s] = voxel_keep(positions, positions, radius)
    weights = torch.arange(32, device=keep.device, dtype=torch.int64)
    words = (keep.reshape(b, t * tile, -1, 32).long() << weights).sum(-1)
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()
    keep_tiles = keep.reshape(b, t, tile, t, tile).any(4).any(2)
    return bits, keep_tiles


def masked_attention_tiled_reference(q, k, v, positions, *, radius: float,
                                     scale: float | None = None,
                                     tile: int = MASK_TILE) -> torch.Tensor:
    """The kernel's tile skipping in plain PyTorch: each query tile attends
    over the keys of its listed tiles only
    (:func:`masked_tile_list_reference`), with the arithmetic of
    :func:`masked_attention_reference` on those keys. Equal to it wherever
    skipping is exact, which is every row that keeps a key."""
    b, h, s, _ = q.shape
    _, keep_tiles = masked_tile_list_reference(positions, radius, tile)
    sc = scale_in_dtype(q, scale)
    keep = voxel_keep(positions, positions, radius)
    out = torch.empty_like(q)
    for bi in range(b):
        for qt in range(keep_tiles.shape[1]):
            rows = slice(qt * tile, min(s, (qt + 1) * tile))
            keys = torch.cat([torch.arange(kt * tile, min(s, (kt + 1) * tile))
                              for kt in keep_tiles[bi, qt].nonzero()[:, 0].tolist()])
            keys = keys.to(q.device)
            qq = q[bi, :, rows]
            logits = torch.matmul((qq * sc).float(),
                                  k[bi][:, keys].float().transpose(-1, -2))
            logits = torch.where(keep[bi, rows][:, keys], logits,
                                 torch.full_like(logits, NEG_INF))
            p = torch.exp(logits - logits.amax(-1, keepdim=True))
            l = p.sum(-1, keepdim=True)
            o = torch.matmul(p.to(v.dtype).float(), v[bi][:, keys].float())
            out[bi, :, rows] = (o / l.clamp(min=1e-30)).to(q.dtype)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("masked_flash")
        lib.m324_masked_flash.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
               ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.m324_masked_flash.restype = ctypes.c_int
        lib.m324_masked_bits.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_void_p])
        lib.m324_masked_bits.restype = ctypes.c_int
        _lib = lib
    return _lib


def _mask_workspace(b: int, s: int, dev) -> tuple[torch.Tensor, int, int]:
    """One int32 buffer for the pre-pass's bits (``(B, T 128, 4 T)``) and
    flags (``(B, T, T)`` bytes), T = ceil(S / 128): (buffer, bits pointer,
    flags pointer)."""
    t = -(-s // MASK_TILE)
    n_bits = b * t * MASK_TILE * 4 * t
    buf = torch.empty(n_bits + -(-(b * t * t) // 4), dtype=torch.int32,
                      device=dev)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n_bits


def _check_positions(positions, b: int, s: int, dev) -> None:
    if positions.shape != (b, s, 3) or positions.dtype != torch.float32:
        raise ValueError(f"positions must be f32 {(b, s, 3)}, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    if positions.device != dev or not positions.is_contiguous() \
            or positions.data_ptr() % 16:
        raise ValueError("positions must be contiguous and 16-byte aligned "
                         "on q's device")


def masked_tile_list(positions, radius: float):
    """``(bits, keep_tiles)`` as :func:`masked_tile_list_reference` gives
    them: on CUDA from K7's pre-pass alone (counted in
    ``masked_tile_list.launches``), on the CPU from the plain version."""
    if positions.device.type == "cpu":
        return masked_tile_list_reference(positions, radius)
    b, s, _ = positions.shape
    dev = positions.device
    _check_positions(positions, b, s, dev)
    t = -(-s // MASK_TILE)
    buf, bits, flags = _mask_workspace(b, s, dev)
    with torch.cuda.device(dev):
        rc = _load().m324_masked_bits(
            positions.data_ptr(), bits, flags, b, s, float(radius) ** 2,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_bits launch failed: error {rc}")
    masked_tile_list.launches += 1
    n_bits = b * t * MASK_TILE * 4 * t
    keep = buf[n_bits:].view(torch.uint8)[: b * t * t].view(b, t, t) != 0
    return buf[:n_bits].view(b, t * MASK_TILE, 4 * t), keep


masked_tile_list.launches = 0


def _forward(q, k, v, positions, radius: float, scale: float) -> torch.Tensor:
    """K7 on CUDA tensors (``scale`` already rounded to q's dtype): q, k, v
    of ``(B, H, S, 64)`` through their strides, the output laid out
    heads-last where q is, else contiguous."""
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
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    _check_positions(positions, b, s, dev)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _forward(q, k, v, positions, radius, scale)
    strides = (map_strides("q", q) + map_strides("k", k)
               + map_strides("v", v))
    out, out_strides = _empty_out(q)
    bf16 = q.dtype == torch.bfloat16
    buf, bits, flags = (_mask_workspace(b, s, dev) if bf16
                        else (None, None, None))
    rc = _load().m324_masked_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
        out.data_ptr(), bits, flags, b, h, s,
        (ctypes.c_longlong * 12)(*strides, *out_strides), scale,
        float(radius) ** 2, _DTYPES[q.dtype],
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"masked_flash launch failed: error {rc} (CUDA "
                           f"error below 900; 900 no cuTensorMapEncodeTiled; "
                           f"901 a call the kernel does not take; 1000 + the "
                           f"tensor-map encoder's error)")
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
    return _forward(q, k, v, positions.float().contiguous(), radius,
                    scale_in_dtype(q, scale))


masked_flash_attention.launches = 0
