"""K6, the single-KV attention forward: its route and its plain version
against the JAX package's Pallas kernel (interpret mode on the CPU).

The port takes K6 for a flash call exactly where the JAX package's ``_fwd``
takes ``_fwd_single_kv``: the KV padded to its block is one block of at
most 1 024 keys. K6's plain version is ``attention_reference``: f32 logits of
q pre-scaled in its dtype, one max over all keys, unnormalised exp rounded
to v's dtype for the second product, f32 sums, division last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops import flash_attention as jfa
from motion324_tpu_torch.ops import flash_attention as fa
from motion324_tpu_torch.ops.attention import multi_head_attention


def _jax_single_kv_route(sk: int) -> bool:
    """The JAX package's decision, read from its own helpers."""
    bkv = jfa._pick_block(sk, 1024, granule=128)
    sk_p = -(-sk // bkv) * bkv
    return jfa._SINGLE_KV and sk_p <= min(bkv, jfa._SINGLE_KV_MAX)


def test_route_matches_the_jax_rule_for_every_kv_up_to_2048():
    port = [fa.single_kv_route(sk) for sk in range(1, 2049)]
    jax_rule = [_jax_single_kv_route(sk) for sk in range(1, 2049)]
    assert port == jax_rule
    on = [sk for sk, r in zip(range(1, 2049), port) if r]
    assert on == list(range(1, 257)) + list(range(385, 1025))


def _jax_single_kv(q, k, v, scale):
    """The JAX forward with the LSE, through ``_fwd`` as ``flash_attention``
    pads and calls it; returns (out (B, H, Sq, D), lse (B*H, Sq))."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq = jfa._pick_block(sq, 1024)
    bkv = jfa._pick_block(sk, 1024, granule=128)
    pad = lambda x, n, m: jnp.pad(x, ((0, 0), (0, -(-n // m) * m - n), (0, 0)))
    qf = pad((q * jnp.asarray(scale, q.dtype)).reshape(b * h, sq, d), sq, bq)
    kf = pad(k.reshape(b * h, sk, d), sk, bkv)
    vf = pad(v.reshape(b * h, sk, d), sk, bkv)
    assert kf.shape[1] <= min(bkv, jfa._SINGLE_KV_MAX)  # the K6 route
    o, lse = jfa._fwd(qf, kf, vf, sk, bq, bkv, True, True)
    return o[:, :sq].reshape(b, h, sq, d), lse[:, :sq, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(100, 200), (64, 512), (40, 1000)])
def test_plain_k6_matches_the_jax_kernel(dtype, sq, sk):
    """bf16: both round P against the same max and the output once, so they
    differ only where an f32 sum taken in another order rounds to another
    bf16 value: at most 2 bf16 ulps of the largest output (2^-7 of max
    |out|). f32 and the f32 LSE: summation order, 1e-5 of max |value|."""
    rng = np.random.default_rng(sk)
    q, k, v = (rng.standard_normal((1, 2, n, 64)).astype(np.float32)
               for n in (sq, sk, sk))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, want_lse = _jax_single_kv(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    0.125)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    assert fa.single_kv_route(sk)
    out, lse = fa._forward(tq, tk, tv, fa.scale_in_dtype(tq, 0.125), True)
    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    top = np.abs(want).max()
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=rel * top)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=1e-5 * np.abs(want_lse).max())
    # without the LSE, through the public wrapper
    np.testing.assert_array_equal(
        fa.flash_attention(tq, tk, tv, scale=0.125).float().numpy(),
        out.float().numpy())


def test_volume_query_shape_takes_the_flash_route_on_k6():
    """8 192 points x 512 latents: too large for K2's 512 x 512 tile, so
    the dispatcher takes the flash route, whose KV fits one block (K6). On
    the CPU the wrapper computes K6's plain version and counts nothing."""
    from motion324_tpu_torch.ops.attention import select_route
    assert select_route(8192, 512) == "flash"
    assert fa.single_kv_route(512)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 256, 2, 64, generator=g)
    k = torch.randn(1, 512, 2, 64, generator=g)
    v = torch.randn(1, 512, 2, 64, generator=g)
    before = (fa.flash_attention.launches, fa.flash_attention.single_kv_launches)
    out = multi_head_attention(q, k, v)
    assert (fa.flash_attention.launches,
            fa.flash_attention.single_kv_launches) == before
    want = multi_head_attention(q, k, v, backend="plain")
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)


def test_single_kv_wrapper_refuses_long_kv_on_cuda_only():
    """Past 1 024 keys K6 is not taken: the wrapper that launches it raises
    (checked before any launch), and the CPU path stays plain."""
    q = torch.zeros(1, 1, 16, 64, device="meta")
    k = torch.zeros(1, 1, 1100, 64, device="meta")
    with pytest.raises(ValueError, match="at most 1024"):
        fa._forward_single_kv(q, k, k, 0.125, False)
    assert not fa.single_kv_route(1100)
