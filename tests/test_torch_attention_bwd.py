"""The port's attention gradients against the JAX package's Pallas kernels.

The plain versions of K1 / K2 with the LSE output and of the backward
kernels K3, K4 and K5 are held on the CPU against ``jax.vjp`` of the Pallas
kernels run in interpret mode, on the same numpy inputs, in f32. On the CPU
the port's differentiable wrappers run exactly those plain versions (its
autograd Functions), so these tests also pin down what the CUDA kernels
must compute; the kernels themselves are tested in
test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops import flash_attention as jax_fa
from motion324_tpu.ops.folded_attention import folded_attention as jax_folded
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.ops.attention import multi_head_attention, select_route
from motion324_tpu_torch.ops.flash_attention import (
    FUSED_BWD_MAX_KV, FlashAttentionFn, flash_attention,
    flash_attention_bwd_reference, flash_attention_reference)
from motion324_tpu_torch.ops.folded_attention import (
    FoldedAttentionFn, folded_attention, folded_attention_bwd_reference,
    folded_attention_reference)

# f32 on both sides, the same math summed in another order. Outputs and LSE
# agree to ~1e-6 as in test_torch_attention.py (2e-5 there); gradients are
# sums over up to 4 200 keys or queries and reach |g| ~ 5, so they are held
# to 1e-4 absolute plus 1e-4 relative.
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _arrays(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _jax_lse(q, k, scale, block):
    """The LSE that JAX's flash forward saves for its backward, (B*H, Sq)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bq = jax_fa._pick_block(sq, block)
    bkv = jax_fa._pick_block(sk, block, granule=128)
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0)))
    qf = pad((jnp.asarray(q) * scale).reshape(b * h, sq, d), jax_fa._ceil_to(sq, bq))
    kf = pad(jnp.asarray(k).reshape(b * h, sk, d), jax_fa._ceil_to(sk, bkv))
    _, lse = jax_fa._fwd(qf, kf, kf, sk, bq, bkv, True, with_lse=True)
    return np.asarray(lse[:, :sq, 0])


@pytest.mark.parametrize("sq,sk", [(200, 1100), (64, 4200)],
                         ids=["fused_ragged", "two_pass"])
def test_flash_grads_match_pallas_vjp(sq, sk):
    """200 x 1100 takes JAX's fused backward (K3's TPU kernel) with ragged
    query and key tails; 64 x 4200 its two-pass backward (K4's)."""
    q, k, v, do = _arrays(0, (1, 2, sq, 64), (1, 2, sk, 64), (1, 2, sk, 64),
                          (1, 2, sq, 64))
    block = 128
    scale = 0.125
    fused = sk <= FUSED_BWD_MAX_KV
    assert fused == (jax_fa._ceil_to(sk, jax_fa._pick_block(sk, block, 128))
                     <= jax_fa._FUSED_BWD_MAX_KV)

    def f(q_, k_, v_):
        return jax_fa.flash_attention(q_, k_, v_, block_q=block, block_kv=block,
                                      interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert isinstance(out.grad_fn, FlashAttentionFn._backward_cls)
    got_grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")

    # the plain forward-with-LSE and the plain backward, called directly
    o, lse = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                       with_lse=True)
    assert lse.shape == (2, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, scale, block),
                               atol=FWD_TOL, rtol=FWD_TOL)
    direct = flash_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse, torch.from_numpy(do))
    for g, w in zip(direct, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_folded_grads_match_pallas_vjp():
    """(B, S, H*64) layout, 2 heads, KV padded to 256 in JAX and masked."""
    b, s, h = 2, 200, 2
    q, k, v, do = _arrays(1, *[(b, s, h * 64)] * 4)

    def f(q_, k_, v_):
        return jax_folded(q_, k_, v_, heads=h, interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = folded_attention(tq, tk, tv, heads=h)
    assert isinstance(out.grad_fn, FoldedAttentionFn._backward_cls)
    got_grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")

    # per-head LSE (B, Sq, H) against JAX's folded forward with its LSE
    qs = jnp.asarray(q) * 0.125
    kp = jnp.pad(jnp.asarray(k), ((0, 0), (0, 56), (0, 0)))
    qp = jnp.pad(qs, ((0, 0), (0, 8), (0, 0)))
    from motion324_tpu.ops.folded_attention import _call_fwd
    _, jlse = _call_fwd(qp, kp, kp, h, 64, s, 1, 208, True)
    o, lse = folded_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                        heads=h, with_lse=True)
    assert lse.shape == (b, s, h)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :s],
                               atol=FWD_TOL, rtol=FWD_TOL)
    direct = folded_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse, torch.from_numpy(do),
        heads=h)
    for g, w in zip(direct, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("sq,sk", [(150, 1100), (150, 150), (150, 64)])
def test_every_route_carries_gradients(sq, sk):
    """Attention that needs grad returns a tensor with a grad_fn on every
    route (K1, K2, plain), and its gradients are those of the plain path."""
    r = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(r.randn(2, n, 2, 64).astype(np.float32))
               .requires_grad_() for n in (sq, sk, sk))
    out = multi_head_attention(q, k, v)
    assert out.grad_fn is not None, select_route(sq, sk)
    do = torch.from_numpy(r.randn(*out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(multi_head_attention(q, k, v, backend="plain"),
                               (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_no_grad_calls_take_the_lse_free_path():
    """Without grad (inference, DINOv2 under no_grad) the wrappers return a
    plain tensor: no autograd Function, no LSE."""
    q = torch.randn(1, 2, 40, 64, requires_grad=True)
    with torch.no_grad():
        assert flash_attention(q, q, q).grad_fn is None
        assert folded_attention(q[0], q[0], q[0], heads=1).grad_fn is None


def test_model_gradients_reach_attention_inputs():
    """Training-mode backward through a tiny model: every trainable
    parameter that feeds attention gets a gradient, the frozen DINOv2 none."""
    cfg = ModelConfig(feat_dim=192, tokens=4, pcd_layers=1,
                      n_alternating_layers=2, head_dim=64, frames=2,
                      image_size=28, patch_size=14, drop_rate=0.0,
                      dino_depth=1, dino_heads=3)
    model = MotionLatentModel(cfg, seed=0)
    model.image_encoder.requires_grad_(False)
    r = np.random.RandomState(3)
    sample = {key: torch.from_numpy(r.randn(1, 130 if key.startswith("ref_shape")
                                            else 10, 3).astype(np.float32))
              for key in ("ref_shape_pcd", "ref_shape_normals", "ref_shape_rgbs",
                          "ref_pcd", "ref_normal", "ref_rgb")}
    sample["rgb_video"] = torch.from_numpy(r.rand(1, 2, 28, 28, 3).astype(np.float32))
    model(sample, train=True).square().mean().backward()
    for name, p in model.named_parameters():
        if name.startswith("image_encoder."):
            assert p.grad is None, name
        else:
            assert p.grad is not None and p.grad.abs().sum() > 0, name
