"""K1's split-KV rule, its plain split-and-combine and its stride checks.

K1 cuts the keys of a call with few query tiles into contiguous ranges, one
block each, and adds the partial results in split order. The number of
ranges is a function of (Sq, Sk) alone, so a slice's bits do not depend on
the batch it runs in. Here, on the CPU: the rule, the plain version of the
split arithmetic (``flash_attention_split_reference``) against the JAX
package's flash forward run in interpret mode and against
``attention_reference``, and the wrapper's checks of the strides the kernel
reads. The kernel itself is held to the same arithmetic on the card
(test_torch_cuda_kernels.py, chip_smoke.py).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops import flash_attention as jfa
from motion324_tpu_torch.ops import flash_attention as fa

# (Sq, Sk) of every K1 row on the paths that must run unsplit: global
# (T = 12 and 16), DiT, DINOv2-giant, the UNet's 64^2 self-attention, its
# multiview attention at three levels, and the ragged check row
UNSPLIT = [(3888, 3888), (5184, 5184), (1881, 1881), (1370, 1370),
           (4096, 4096), (24576, 24576), (6144, 6144), (1536, 1536),
           (1000, 1296)]


def test_split_count_depends_on_the_lengths_only():
    assert list(inspect.signature(fa.split_count).parameters) == ["sq", "sk"]
    for sq, sk in UNSPLIT:
        assert fa.split_count(sq, sk) == 1, (sq, sk)
    # the shape encoder at inference (16 384 samples) and in training
    # (4 096): at B = 1 (12 heads, one 64-row query tile) at least 132
    # blocks, one per SM of the H100
    for sk in (16384, 4096):
        n = fa.split_count(64, sk)
        assert 12 * n >= 132, (sk, n)
    assert fa.split_ranges(16384, fa.split_count(64, 16384)) == [
        (i * 1024, (i + 1) * 1024) for i in range(16)]


@pytest.mark.parametrize("sq", [1, 64, 65, 200, 700, 1000])
def test_split_ranges_cover_the_keys_in_whole_tiles(sq):
    for sk in list(range(257, 2100, 37)) + [4096, 4200, 16384, 16385]:
        n = fa.split_count(sq, sk)
        ranges = fa.split_ranges(sk, n)
        assert len(ranges) == n
        assert ranges[0][0] == 0 and ranges[-1][1] == sk
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c and (b - a) % fa.K1_KV_TILE == 0
        assert all(b > a for a, b in ranges), (sq, sk, ranges)


def _jax_flash(q, k, v, scale):
    """The JAX forward with the LSE through ``_fwd``, padded as
    ``flash_attention`` pads: (out (B, H, Sq, D), lse (B*H, Sq))."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq = jfa._pick_block(sq, 1024)
    bkv = jfa._pick_block(sk, 1024, granule=128)
    pad = lambda x, n, m: jnp.pad(x, ((0, 0), (0, -(-n // m) * m - n), (0, 0)))
    qf = pad((q * jnp.asarray(scale, q.dtype)).reshape(b * h, sq, d), sq, bq)
    kf = pad(k.reshape(b * h, sk, d), sk, bkv)
    vf = pad(v.reshape(b * h, sk, d), sk, bkv)
    o, lse = jfa._fwd(qf, kf, vf, sk, bq, bkv, True, True)
    return np.asarray(o[:, :sq].reshape(b, h, sq, d)), np.asarray(lse[:, :sq, 0])


@pytest.mark.parametrize("sq,sk", [(64, 1500), (200, 4200)])
def test_split_reference_matches_the_jax_kernel(sq, sk):
    """f32: the same function summed in another order, 1e-5 of max |ref|
    for the output and the LSE. 64 x 1 500 is 12 splits with a ragged last
    tile; 200 x 4 200 is 7 splits of 640 keys, the last of 360."""
    n = fa.split_count(sq, sk)
    ranges = fa.split_ranges(sk, n)
    assert n > 1 and ranges[-1][1] - ranges[-1][0] < ranges[0][1] - ranges[0][0]
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal((1, 2, m, 64)).astype(np.float32)
               for m in (sq, sk, sk))
    want, want_lse = _jax_flash(*(jnp.asarray(x) for x in (q, k, v)), 0.125)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.flash_attention_split_reference(tq, tk, tv, n, scale=0.125)
    plain, plain_lse = fa.attention_reference(tq, tk, tv, 0.125, with_lse=True)
    for got, ref in ((out, want), (lse.reshape(-1, sq), want_lse),
                     (out, plain.numpy()), (lse, plain_lse.numpy())):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_stride_checks():
    """K1 reads (B, H, S, 64) through (batch, head, row) strides: the
    dispatcher's transposed (B, S, H, 64) views and contiguous tensors pass;
    a non-unit head-dim stride and a misaligned base or row are refused."""
    bshd = torch.zeros(2, 100, 3, 64, dtype=torch.bfloat16)
    view = bshd.transpose(1, 2)
    fa._check(view, view, view)
    fa._check(view.contiguous(), view, view)
    # q/k/v as views of one fused projection (B, S, 3 H D)
    qkv = torch.zeros(2, 100, 3 * 3 * 64, dtype=torch.bfloat16)
    split = [x.unflatten(-1, (3, 64)).transpose(1, 2)
             for x in qkv.split(3 * 64, dim=-1)]
    fa._check(*split)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros(2, 3, 100, 128, dtype=torch.bfloat16)[..., ::2]
        fa._check(t, view, view)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(2 * 3 * 100 * 64 + 1, dtype=torch.bfloat16)
        fa._check(view, flat[1:].view(2, 3, 100, 64), view)
    with pytest.raises(ValueError, match="aligned"):
        rows = torch.zeros(2, 3, 100, 68, dtype=torch.bfloat16)[..., :64]
        fa._check(view, view, rows)
    # size-1 batch and head dims take any stride; the kernel is handed
    # aligned ones for them
    one = torch.zeros(1, 100, 1, 64, dtype=torch.bfloat16).transpose(1, 2)
    strides = fa._check(one, one, one)
    assert len(strides) == 9 and all(s > 0 and s % 8 == 0 for s in strides)
    assert strides[2] == 64 and fa._check(view, view, view)[:3] == [
        100 * 3 * 64, 64, 3 * 64]
