"""K6 (single-KV forward) and K5 (head-folded backward) on the CPU: what
their wrappers hand the kernels, and K5's plain version against the JAX
package's Pallas kernel.

K6 walks whole query tiles of one (batch, head) slice per block with the
slice's K resident in shared memory, and V too up to 512 keys
(``single_kv_plan``); it reads the dispatcher's ``(B, S, H, 64)`` views
through their strides and writes its output heads-last. K5 is the K9
backward's two passes over the ``B*H`` slices (``folded_bwd_plan``), reading
q, k, v, o and dO of the ``(B, S, H*64)`` layout through strides and writing
contiguous dq, dk and dv (``folded_bwd_strides``). The kernels themselves
run on the card (test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops.folded_attention import folded_attention as jax_folded
from motion324_tpu_torch.ops import flash_attention as fa
from motion324_tpu_torch.ops import folded_attention as fo
from motion324_tpu_torch.ops import short_attention as sa

# a block's shared memory on the H100 (227 KB)
SMEM_MAX = 232448


def _k6_smem(consumers: int, sk: int, v_resident: bool) -> int:
    """K6's dynamic shared memory (``Layout`` in csrc/flash_single_kv.cu):
    two Q stages of 64-row tiles per consumer, K's 128-key tiles, V's tiles
    or a 2-stage ring, 10 mbarriers, 1 KB of alignment slack."""
    tiles = -(-sk // 128)
    tile = 128 * 64 * 2
    return (2 * consumers * 64 * 64 * 2 + tiles * tile
            + (tiles if v_resident else 2) * tile + 8 * 10 + 1024)


def test_k6_keeps_v_resident_up_to_512_keys():
    """For every KV on K6's route: V resident for Sk <= 512, streamed
    above; the block fits in shared memory either way, at one consumer
    (Sq <= 64) and two."""
    route = [sk for sk in range(1, 1025) if fa.single_kv_route(sk)]
    assert route == list(range(1, 257)) + list(range(385, 1025))
    for sk in route:
        for sq in (50, 8192):
            consumers, per, resident = fa.single_kv_plan(16, sq, sk)
            assert consumers == (1 if sq <= 64 else 2)
            assert resident == (sk <= 512), sk
            assert _k6_smem(consumers, sk, resident) <= SMEM_MAX, sk
    assert _k6_smem(2, 512, True) == 160 * 1024 + 1104
    assert _k6_smem(2, 1024, False) == 192 * 1024 + 1104


@pytest.mark.parametrize("bh,sq,want", [(16, 8192, 8), (60, 1024, 4),
                                        (24, 1000, 2), (16, 50, 1),
                                        (1, 130, 1)])
def test_k6_plan_fills_the_card_with_whole_tiles(bh, sq, want):
    """The tiles a block walks: the fewest waves of 132 blocks times tiles
    a block, the larger count on a tie. The volume query (16 slices x 64
    tiles) runs 128 blocks of 8 tiles, the UNet's 32^2 level (60 x 8) 120
    of 4; every tile of every slice lies in exactly one block."""
    consumers, per, _ = fa.single_kv_plan(bh, sq, 512)
    assert per == want
    q_tiles = -(-sq // (64 * consumers))
    blocks = -(-q_tiles // per)
    covered = sorted(t for x in range(blocks)
                     for t in range(x * per, min(q_tiles, (x + 1) * per)))
    assert covered == list(range(q_tiles))


def test_k6_takes_the_dispatchers_views_without_a_copy():
    """The strides K6 is handed: the (B, S, H, 64) views' own for q, k and v
    (so their storage is read in place) and, for the output, those of a
    heads-last tensor seen as (B, H, Sq, 64), which the dispatcher's
    transpose turns back into a contiguous (B, Sq, H, 64)."""
    b, h, sq, sk = 2, 3, 100, 512
    q, k, v = (torch.zeros(b, n, h, 64, dtype=torch.bfloat16).transpose(1, 2)
               for n in (sq, sk, sk))
    strides = fa._check(q, k, v)
    assert strides == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    assert strides[:3] == [sq * h * 64, 64, h * 64]
    out, out_strides = fa._empty_out(q)
    assert out.shape == (b, h, sq, 64)
    assert out_strides == list(out.stride()[:3]) == [sq * h * 64, 64, h * 64]
    assert out.transpose(1, 2).is_contiguous()
    # contiguous (B, H, S, 64) inputs give a contiguous output
    out, out_strides = fa._empty_out(q.contiguous())
    assert out.is_contiguous() and out_strides == [h * sq * 64, sq * 64, 64]


# (B, H, Sq, Sk) of K5's calls: the training's local layers, a ragged row,
# and a shape whose dq pass splits its keys
K5_SHAPES = [(24, 12, 324, 324), (2, 12, 200, 300), (2, 12, 64, 4096)]


@pytest.mark.parametrize("b,h,sq,sk", K5_SHAPES)
def test_k5_plan_is_k9s_over_the_slices(b, h, sq, sk):
    """K5 runs the K9 backward's passes over its B*H slices, so its splits,
    workspace and tickets are K9's for that many slices; the local and
    ragged rows run unsplit, 64 x 4 096 splits its keys 16 ways."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = fo.folded_bwd_plan(b, h, sq, sk, dtype)
        assert plan == sa.short_bwd_plan(b * h, sq, sk, dtype)
    n_split, dkv_split, floats, tickets = fo.folded_bwd_plan(
        b, h, sq, sk, torch.bfloat16)
    assert dkv_split == 1
    assert n_split == (16 if sq == 64 else 1)
    rows = b * h * -(-sq // 128) * 128
    assert floats == 2 * rows + (n_split * rows * 64 if n_split > 1 else 0)
    assert tickets == (b * h if n_split > 1 else 0)
    assert fo.folded_bwd_plan(b, h, sq, sk, torch.float32) == (1, 1, 0, 0)


def test_k5_strides_of_fused_qkv_views():
    """What K5 is handed for q, k and v sliced from one fused
    (B, S, 3 H 64) projection: head stride 64 and the projection's row and
    batch strides; o and dO contiguous (B, Sq, H*64); the lse (B, Sq, H) as
    (batch Sq H, head 1, row H); dq, dk and dv contiguous (B, S, H*64).
    A misaligned row is refused."""
    b, h, sq, sk = 2, 3, 80, 100
    c = h * 64
    qkv = torch.zeros(b, sk, 3 * c, dtype=torch.bfloat16)
    q, k, v = qkv[:, :sq, :c], qkv[:, :, c:2 * c], qkv[:, :, 2 * c:]
    o = do = torch.zeros(b, sq, c, dtype=torch.bfloat16)
    lse = torch.zeros(b, sq, h)
    st = fo.folded_bwd_strides(q, k, v, o, do, lse, h)
    fused = [sk * 3 * c, 64, 3 * c]
    assert st[:9] == fused * 3
    assert st[9:15] == [sq * c, 64, c] * 2
    assert st[15:18] == [lse.stride(0), lse.stride(2), lse.stride(1)]
    assert st[18:] == [sq * c, 64, c, sk * c, 64, c, sk * c, 64, c]
    # the strides point where the views' elements lie
    x = torch.arange(b * sk * 3 * c, dtype=torch.float32).view(b, sk, 3 * c)
    kx = x[:, :, c:2 * c]
    bs, hs, rs = st[3:6]
    assert kx[1, 7, 2 * 64 + 5].item() == (c + bs + 2 * hs + 7 * rs + 5)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(b * sk * 3 * c + 1, dtype=torch.bfloat16)
        bad = flat[1:].view(b, sk, 3 * c)[:, :, :c]
        fo.folded_bwd_strides(bad[:, :sq], k, v, o, do, lse, h)


def test_k5_plain_backward_matches_pallas_vjp():
    """K5's plain backward on the folded layout, 2 images x 2 heads x
    72 queries x 136 keys (ragged in the TPU kernel's 16 / 128 tiles),
    against jax.vjp of the Pallas kernel in interpret mode, f32 on both
    sides. Gradients are sums over up to 136 keys or 72 queries: held to
    1e-4 absolute plus 1e-4 relative, as test_torch_attention_bwd.py holds
    the larger rows."""
    b, h, sq, sk = 2, 2, 72, 136
    r = np.random.RandomState(3)
    q, do = (r.randn(b, sq, h * 64).astype(np.float32) for _ in range(2))
    k, v = (r.randn(b, sk, h * 64).astype(np.float32) for _ in range(2))
    f = lambda q_, k_, v_: jax_folded(q_, k_, v_, heads=h, interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fo.folded_attention_reference(tq, tk, tv, heads=h, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    sc = fo._default_scale(tq, h, None)
    got = fo.folded_attention_bwd(tq * sc, tk, tv, o, lse,
                                  torch.from_numpy(do), heads=h)
    for name, g, w in zip("qkv", got, want_grads):
        if name == "q":
            g = g * sc       # the wrapper's gradient is for the scaled q
        assert g.is_contiguous() and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{name}")
