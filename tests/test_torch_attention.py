"""The port's attention against the JAX package's Pallas kernels.

The plain versions of K1 (flash) and K2 (head-folded) are held on the CPU
against the Pallas kernels run in interpret mode, on the same numpy inputs;
the port's router against the JAX router's choices. The CUDA kernels
themselves are tested in test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motion324_tpu.ops.attention as jax_attention
from motion324_tpu.ops.flash_attention import flash_attention as jax_flash
from motion324_tpu.ops.folded_attention import folded_attention as jax_folded
from motion324_tpu_torch.ops import attention as port_attention
from motion324_tpu_torch.ops.attention import (mha_reference,
                                               multi_head_attention,
                                               select_route)
from motion324_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_reference)
from motion324_tpu_torch.ops.folded_attention import (
    folded_attention, folded_attention_reference)

# f32 on both sides: the same math summed in another order; the JAX
# package's own kernel tests hold 2e-5 (tests/test_attention.py)
TOL = 2e-5


def _qkv(seed, qshape, kshape):
    r = np.random.RandomState(seed)
    return (r.randn(*qshape).astype(np.float32),
            r.randn(*kshape).astype(np.float32),
            r.randn(*kshape).astype(np.float32))


@pytest.mark.parametrize("sq,sk", [(200, 300), (64, 300), (256, 256)])
def test_flash_plain_matches_pallas_interpret(sq, sk):
    """Ragged lengths (KV tail masked in a 128-block), Sq < Sk, and an
    exact fit; several KV blocks exercise the Pallas online softmax."""
    q, k, v = _qkv(0, (2, 3, sq, 64), (2, 3, sk, 64))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=128, block_kv=128, interpret=True))
    got = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("sq,sk", [(257, 257), (324, 324), (200, 300)])
def test_folded_plain_matches_pallas_interpret(sq, sk):
    """(B, S, H*D) layout; KV padded to 384 / 384 / 384 and masked."""
    b, h = 2, 3
    q, k, v = _qkv(1, (b, sq, h * 64), (b, sk, h * 64))
    want = np.asarray(jax_folded(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), heads=h, interpret=True))
    got = folded_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), heads=h).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wrappers_take_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, (1, 2, 40, 64), (1, 2, 70, 64)))
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_reference(q, k, v))
    f = lambda x: x.transpose(1, 2).flatten(2)
    torch.testing.assert_close(folded_attention(f(q), f(k), f(v), heads=2),
                               folded_attention_reference(f(q), f(k), f(v), heads=2))
    assert flash_attention.launches == 0 and folded_attention.launches == 0


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        folded_attention(q[0], q[0], q[0], heads=1)


# (Sq, Sk) of the call sites: global attention of a 12-frame window, shape
# encoder, local frame attention, DINOv2, a 3-frame window (K6 route in JAX),
# ShapeVAE volume decode, point decoder, pcd blocks, short queries
SHAPES = [(3888, 3888), (64, 16384), (324, 324), (257, 257), (972, 972),
          (8192, 512), (162, 64), (64, 64), (100, 640), (128, 128), (1000, 1296)]


def _jax_route(monkeypatch, sq, sk):
    """Which kernel the JAX dispatcher picks on a TPU for these lengths."""
    seen = []
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_attention, "flash_attention",
                        lambda q, *a, **kw: seen.append("flash") or q)
    monkeypatch.setattr(
        jax_attention, "folded_attention",
        lambda q, *a, **kw: seen.append("folded") or q)
    q = jnp.zeros((1, sq, 1, 8))
    k = jnp.zeros((1, sk, 1, 8))
    jax_attention.multi_head_attention(q, k, k)
    return seen[0] if seen else "plain"


@pytest.mark.parametrize("sq,sk", SHAPES)
def test_route_matches_jax_dispatcher(monkeypatch, sq, sk):
    assert select_route(sq, sk) == _jax_route(monkeypatch, sq, sk)


def test_route_thresholds_are_the_jax_ones():
    assert port_attention.FLASH_MIN_KV == jax_attention._FLASH_MIN_KV
    assert port_attention.SHORT_MIN_KV == jax_attention._SHORT_MIN_KV
    assert port_attention.SHORT_MIN_Q == jax_attention._SHORT_MIN_Q
    assert port_attention.SHORT_MAX_AREA == jax_attention._SHORT_MAX_AREA


@pytest.mark.parametrize("backend,sk,route", [
    (None, 1100, "flash"), (None, 150, "folded"), (None, 64, "plain"),
    ("plain", 150, "folded")])
def test_dispatcher_backends_agree(backend, sk, route):
    """Every route of multi_head_attention, and backend="plain" on a shape
    that routes to a kernel, computes the same attention over (B, S, H, D),
    on q/k/v that are strided views of a fused projection. ``route`` is
    the route of the shape."""
    r = np.random.RandomState(3)
    qkv = torch.from_numpy(r.randn(2, max(150, sk), 3 * 4 * 64).astype(np.float32))
    q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(256, dim=-1))
    q, k, v = q[:, :150], k[:, :sk], v[:, :sk]
    assert select_route(150, sk) == route
    got = multi_head_attention(q, k, v, backend=backend)
    want = mha_reference(q, k, v)
    assert got.shape == (2, 150, 4, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_mha_reference_matches_jax():
    q, k, v = _qkv(4, (2, 50, 3, 16), (2, 90, 3, 16))
    want = np.asarray(jax_attention.mha_reference(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)))
    ).transpose(0, 2, 1, 3)
    got = mha_reference(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

