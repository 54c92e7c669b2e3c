"""K2 (head-folded forward) and K7 (voxel-masked forward) on the CPU: what
their wrappers hand the Hopper forward, and the plain versions of K7's
pre-pass and tile skipping.

K2 is K1's Hopper forward under K2's name: q, k and v go in as
``(B, H, S, 64)`` views of the ``(B, S, H*64)`` layout, the output is
written heads-last and the LSE through ``(B, Sq, H)`` strides, the layout
that K5 and ``FoldedAttentionFn`` read; K1 and K9 keep their compact
``(B*H, Sq)`` LSE. K7's pre-pass writes the mask bits once per batch and
flags the 128 x 128 tiles that hold a kept pair; the main loop visits the
flagged tiles only (``masked_tile_list_reference`` and
``masked_attention_tiled_reference`` are their plain versions, held here to
``voxel_keep``, ``masked_attention_reference`` and the JAX package's Pallas
kernel in interpret mode). The kernels themselves run on the card
(test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops.masked_attention import masked_flash_attention as jmask
from motion324_tpu_torch.hy3dgen import voxel_attention as tva
from motion324_tpu_torch.ops import flash_attention as fa
from motion324_tpu_torch.ops import folded_attention as fo
from motion324_tpu_torch.ops import masked_attention as ma

# f32 on both sides, the same attention with its sums in another order:
# 1e-5 of the largest output (as in test_torch_masked_attention.py)
REL = 1e-5


@pytest.mark.parametrize("b,h,sq", [(1, 12, 324), (4, 3, 257), (2, 16, 64)])
def test_lse_strides_are_the_layouts_the_backwards_read(b, h, sq):
    """K1 and K9 write the compact (B*H, Sq) LSE that K3 / K4 and the K9
    backward read; K2 writes (B, Sq, H), seen as (B, H, Sq)."""
    compact = torch.empty(b * h, sq).view(b, h, sq)
    assert fa.lse_strides(b, h, sq, heads_last=False) == list(compact.stride())
    folded = torch.empty(b, sq, h).permute(0, 2, 1)
    assert fa.lse_strides(b, h, sq, heads_last=True) == list(folded.stride())


@pytest.mark.parametrize("fused", [True, False], ids=["fused_qkv", "separate"])
@pytest.mark.parametrize("b,h,sq,sk", [(24, 12, 324, 324), (2, 12, 200, 1000),
                                       (1, 16, 512, 512)])
def test_k2_strides_are_what_k5_reads(fused, b, h, sq, sk):
    """The 15 strides K2 is handed: q, k, v as K5 reads them (3 H 64 rows on
    the fused-QKV slices), the output's (the contiguous (B, Sq, H*64) seen
    as (B, H, Sq, 64)), and the LSE's as K5 reads it; the forward's (out,
    lse) on the CPU have exactly those layouts."""
    c = 64 * h
    if fused:
        qkv = torch.randn(b, max(sq, sk), 3 * c)
        q, k, v = qkv[:, :sq, :c], qkv[:, :sk, c:2 * c], qkv[:, :sk, 2 * c:]
    else:
        q, k, v = torch.randn(b, sq, c), torch.randn(b, sk, c), torch.randn(b, sk, c)
    st = fo.folded_fwd_strides(q, k, v, h)
    out, lse = fo._forward(q, k, v, h, 0.125, with_lse=True)
    assert out.shape == (b, sq, c) and out.is_contiguous()
    assert lse.shape == (b, sq, h) and lse.is_contiguous()
    bwd = fo.folded_bwd_strides(q, k, v, out, out, lse, h)
    assert st[:9] == bwd[:9]
    assert st[12:] == bwd[15:18] == list(lse.permute(0, 2, 1).stride())
    assert st[9:12] == list(out.unflatten(-1, (h, 64)).transpose(1, 2).stride()[:3])
    if fused:
        assert st[2] == st[5] == st[8] == 3 * c and st[1] == 64


def _surface(seed, b, s):
    """Cell positions as surface_positions in chip_smoke.py draws them: on a
    sphere inside the unit box in random order, an eighth at the origin."""
    rng = np.random.RandomState(seed)
    p = rng.randn(b, s, 3)
    p = 0.5 + 0.45 * p / np.linalg.norm(p, axis=-1, keepdims=True)
    p[:, : s // 8] = 0.0
    return torch.from_numpy(p.astype(np.float32))


def _raster(n_views, hw, g):
    """Cell positions in the paint path's order (voxel_positions: view by
    view, raster order over the g x g cells): view 0 a wavy sheet that
    fills it, the others a disk above it on a background (cells at the
    origin)."""
    u, w = np.meshgrid((np.arange(hw) + 0.5) / hw, (np.arange(hw) + 0.5) / hw)
    maps = []
    for i in range(n_views):
        z = 0.3 + 0.4 * (i > 0) + 0.1 * np.sin(3 * u + i) * np.cos(2 * w)
        m = np.stack([u, w, z], -1)
        if i > 0:
            m[(u - 0.5) ** 2 + (w - 0.5) ** 2 > 0.35 ** 2] = 1.0
        maps.append(m)
    pm = torch.from_numpy(np.stack(maps)[None].astype(np.float32))
    return tva.voxel_positions(pm, g)


def _positions(order):
    if order == "surface":
        return _surface(3, 2, 300), 1.73 / 4
    return _raster(2, 96, 24)     # 1 152 tokens, r = 1.73 / 24


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("order", ["surface", "raster"])
def test_tile_list_is_exact(order, tile):
    """The bits are voxel_keep on the real pairs and clear past S; a tile is
    listed iff it holds a kept pair; every diagonal tile is listed. On the
    raster order the plane's far tiles are skipped."""
    pos, r = _positions(order)
    b, s, _ = pos.shape
    t = -(-s // tile)
    bits, tiles = ma.masked_tile_list_reference(pos, r, tile)
    assert bits.dtype == torch.int32 and bits.shape == (b, t * tile, t * tile // 32)
    assert tiles.shape == (b, t, t)
    words = bits.long() & 0xFFFFFFFF
    dec = ((words[..., None] >> torch.arange(32)) & 1).bool().reshape(
        b, t * tile, t * tile)
    keep = ma.voxel_keep(pos, pos, r)
    assert torch.equal(dec[:, :s, :s], keep)
    assert not dec[:, s:].any() and not dec[:, :, s:].any()
    for bi in range(b):
        for qt in range(t):
            for kt in range(t):
                block = keep[bi, qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile]
                assert bool(tiles[bi, qt, kt]) == bool(block.any())
        assert tiles[bi].diagonal().all()
    if order == "raster":
        assert not tiles.all()


@pytest.mark.parametrize("order,h,tile", [("surface", 3, 128), ("surface", 2, 64),
                                          ("raster", 2, 128), ("raster", 1, 64)])
def test_tiled_plain_matches_reference_and_pallas(order, h, tile):
    """Attending over the listed tiles only gives the plain version's and
    the Pallas kernel's result (interpret mode), f32, within REL of the
    largest output."""
    pos, r = _positions(order)
    b, s, _ = pos.shape
    rng = np.random.RandomState(s + h)
    q, k, v = (rng.randn(b, h, s, 64).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ma.masked_attention_tiled_reference(tq, tk, tv, pos, radius=r,
                                              tile=tile).numpy()
    want = ma.masked_attention_reference(tq, tk, tv, pos, radius=r).numpy()
    atol = REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    pallas = np.asarray(jmask(*(jnp.asarray(x) for x in (q, k, v, pos.numpy())),
                              radius=r, block_q=128, block_kv=128,
                              interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol)


def test_masked_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing."""
    pos, r = _positions("raster")
    before = ma.masked_tile_list.launches, ma.masked_flash_attention.launches
    bits, tiles = ma.masked_tile_list(pos, r)
    want = ma.masked_tile_list_reference(pos, r)
    assert torch.equal(bits, want[0]) and torch.equal(tiles, want[1])
    q = torch.randn(1, 2, pos.shape[1], 64)
    out = ma.masked_flash_attention(q, q, q, pos, radius=r)
    assert torch.equal(out, ma.masked_attention_reference(q, q, q, pos, radius=r))
    assert (ma.masked_tile_list.launches,
            ma.masked_flash_attention.launches) == before
