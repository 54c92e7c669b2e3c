"""K9, the short-attention kernel of the "short_legacy" backend, against the
JAX package, on the CPU.

The port's plain K9 forward and backward (which its wrappers run on a CPU
tensor, and which the CUDA kernels are held to on the card) against the
Pallas kernels in interpret mode and ``jax.vjp`` of them, on the same numpy
inputs; the dispatcher's backend names against JAX's; the tiny motion model
and one training step on the legacy route against the JAX model on
``"short_legacy_interpret"``; DINOv2 left on its automatic route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.ops.attention import multi_head_attention as jax_mha
from motion324_tpu.ops.short_attention import short_attention as jax_short
from motion324_tpu.training.loss import coord_mse_loss as jax_loss
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.ops import short_attention as sa
from motion324_tpu_torch.ops.attention import multi_head_attention
from motion324_tpu_torch.ops.short_attention import (ShortAttentionFn,
                                                     short_attention,
                                                     short_attention_reference)
from motion324_tpu_torch.training.loss import coord_mse_loss
from motion324_tpu_torch.training.train_step import (create_train_state,
                                                     train_step)
from motion324_tpu_torch.utils.convert import params_from_jax

# f32 on both sides, the same math summed in another order: outputs and
# gradients agree to a few ulps of their largest value (sums over at most
# 700 keys), so both are held to 1e-5 of max |want|.
F32_TOL = 1e-5
# bf16 on both sides: XLA's and torch's exp differ by an f32 ulp, which can
# move a rounding of P or of dS by one bf16 ulp (2^-8), and each output is
# rounded once to bf16: held to 2^-6 of max |want|, as the card's kernels
# are held to their plain versions.
BF16_TOL = 2.0 ** -6
# the tiny model and its gradients, f32: as tests/test_torch_model.py and
# tests/test_torch_train_step.py hold the automatic route
MODEL_TOL = 1e-4
GRAD_REL = 1e-4

SHAPES = [(37, 200), (324, 324), (64, 700), (162, 64)]
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=2, image_size=28, patch_size=14,
             drop_rate=0.0, dino_depth=1, dino_heads=3)


def _arrays(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _assert_close(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    top = np.abs(want).max()
    assert err <= rel * top, f"{what}: max|d| {err:.3e} > {rel:.1e} x {top:.3e}"


# f32 at the default scale 1/8 and at 0.31, bf16 at the model's 1/8
CASES = ([(sq, sk, scale, "float32") for sq, sk in SHAPES for scale in (None, 0.31)]
         + [(sq, sk, None, "bfloat16") for sq, sk in SHAPES])


@pytest.mark.parametrize("sq,sk,scale,dtype", CASES,
                         ids=[f"{a}x{b}-{s or 'default'}-{d}" for a, b, s, d in CASES])
def test_plain_k9_matches_pallas_forward_and_vjp(sq, sk, scale, dtype):
    """Ragged query and key counts (none a multiple of 16 / 128 but 64),
    the default 1/8 scale and 0.31, which bf16 would round; the gradient
    flows back through the pre-scale of q in q's dtype."""
    q, k, v, do = _arrays(sq + sk, (1, 2, sq, 64), (1, 2, sk, 64),
                          (1, 2, sk, 64), (1, 2, sq, 64))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def f(q_, k_, v_):
        return jax_short(q_, k_, v_, scale=scale, interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do, jdt))

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = short_attention(tq, tk, tv, scale=scale)
    # the Function takes and returns (B, H, S, D): its node is the output's
    assert isinstance(out.grad_fn, ShortAttentionFn._backward_cls)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).to(tdt))
    with torch.no_grad():
        fwd_only = short_attention(tq, tk, tv, scale=scale)
    assert out.dtype == fwd_only.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    to_np = lambda t: t.detach().float().numpy()
    _assert_close(to_np(out), np.asarray(want, np.float32), tol, "out")
    np.testing.assert_array_equal(to_np(fwd_only), to_np(out))
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        _assert_close(to_np(g), np.asarray(w, np.float32), tol, name)


def test_plain_k9_lse_is_the_log_sum_exp():
    q, k = _arrays(5, (2, 3, 40, 16), (2, 3, 90, 16))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = short_attention_reference(tq, tk, tk, scale=0.31, with_lse=True)
    want = torch.logsumexp(0.31 * tq @ tk.transpose(-1, -2), dim=-1)
    assert lse.shape == (6, 40) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want.reshape(6, 40).numpy(),
                               atol=1e-5, rtol=1e-6)


# (port backend, JAX backend): the port refuses the JAX package's
# interpreter names, so its kernel routes stand against them
BACKENDS = [("short_legacy", "short_legacy_interpret"),
            ("short", "short_interpret"), ("flash", "interpret"),
            ("xla", "xla"), ("plain", "xla"), (None, "xla")]


@pytest.mark.parametrize("backend,jax_backend", BACKENDS,
                         ids=[str(b) for b, _ in BACKENDS])
def test_dispatcher_backend_names_match_jax(backend, jax_backend):
    """(B, S, H, D) with ragged lengths; q/k/v are views of one fused
    projection, as the model hands them over."""
    r = np.random.RandomState(7)
    qkv = r.randn(2, 200, 3 * 2 * 64).astype(np.float32)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].reshape(2, 200, 2, 64)
               for i in range(3))
    q = q[:, :150]
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   scale=0.2, backend=jax_backend)
    tq, tk, tv = (torch.from_numpy(qkv).split(128, dim=-1)[i]
                  .unflatten(-1, (2, 64)) for i in range(3))
    got = multi_head_attention(tq[:, :150], tk, tv, scale=0.2, backend=backend)
    assert got.shape == (2, 150, 2, 64)
    _assert_close(got.numpy(), np.asarray(want), F32_TOL, str(backend))


@pytest.mark.parametrize("name", ["interpret", "short_legacy_interpret",
                                  "short_interpret", "pallas"])
def test_dispatcher_refuses_other_names(name):
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="unknown attention backend"):
        multi_head_attention(x, x, x, backend=name)


def _batch(seed, b=2, s=16, n=8, t=2, hw=28):
    r = np.random.RandomState(seed)
    out = {k: r.randn(b, s if k.startswith("ref_shape") else n, 3).astype(np.float32)
           for k in ("ref_shape_pcd", "ref_shape_normals", "ref_pcd", "ref_normal")}
    out["ref_shape_rgbs"] = r.rand(b, s, 3).astype(np.float32)
    out["ref_rgb"] = r.rand(b, n, 3).astype(np.float32)
    out["rgb_video"] = r.rand(b, t, hw, hw, 3).astype(np.float32)
    out["point_clouds"] = (r.randn(b, t, n, 3) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def legacy():
    """The JAX model on the legacy route in interpret mode, perturbed init
    params, and the port's model on "short_legacy" with the same weights."""
    jmodel = JaxModel(JaxConfig(**SMALL, attn_backend="short_legacy_interpret"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), _batch(0))
    r = np.random.RandomState(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(params))
    model = MotionLatentModel(ModelConfig(**SMALL, attn_backend="short_legacy"),
                              seed=None)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model


@pytest.fixture
def k9_calls(monkeypatch):
    """Counts of the K9 forward (by LSE variant) and backward calls, on the
    CPU where the wrappers' launch counters stay at 0."""
    calls = {"fwd": 0, "fwd_lse": 0, "bwd": 0}
    real_fwd, real_bwd = sa._forward, sa.short_attention_bwd

    def fwd(q, k, v, scale, with_lse):
        calls["fwd_lse" if with_lse else "fwd"] += 1
        return real_fwd(q, k, v, scale, with_lse)

    def bwd(*args):
        calls["bwd"] += 1
        return real_bwd(*args)
    monkeypatch.setattr(sa, "_forward", fwd)
    monkeypatch.setattr(sa, "short_attention_bwd", bwd)
    return calls


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# K9 calls in one forward of the tiny model (2 frames, decode chunk 1): the
# encoder's cross-attention, 1 pcd block, 1 global and 1 local block, and
# the decoder once per frame; DINOv2 takes none
TINY_CALLS = 1 + 1 + 1 + 1 + 2


def test_legacy_model_matches_jax(legacy, k9_calls):
    jmodel, params, model = legacy
    batch = _batch(3)
    want = np.asarray(jax.jit(jmodel.apply)(params, batch))
    with torch.no_grad():
        got = model(_torch(batch)).numpy()
    assert got.shape == want.shape == (2, 2, 8, 3)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert k9_calls == {"fwd": TINY_CALLS, "fwd_lse": 0, "bwd": 0}


def test_legacy_train_step_grads_match_jax(legacy, k9_calls):
    """Per-parameter gradients of one step's loss, then the port's
    train_step on the same batch: it reaches ShortAttentionFn's backward
    once per motion attention call, and its loss and gradient norm are
    JAX's."""
    jmodel, params, model = legacy
    batch = _batch(4)

    def loss_fn(p):
        return jax_loss(jmodel.apply(p, batch, train=True,
                                     rngs={"dropout": jax.random.PRNGKey(0)}),
                        batch["point_clouds"])[0]
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    jnorm = float(np.sqrt(sum(float(jnp.sum(g.astype(jnp.float32) ** 2))
                              for g in jax.tree.leaves(jg))))

    model = MotionLatentModel(model.cfg, seed=None)   # a copy to train
    model.load_state_dict(legacy[2].state_dict())
    cfg = load_train_config("configs/dyscene.yaml", [
        "training.warmup=0", "training.lr=1e-3", "training.grad_accum_steps=1",
        "training.allowed_gradnorm_factor=1e9", "training.remat=false"])
    state = create_train_state(model, cfg)
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    loss, _ = coord_mse_loss(model(_torch(batch), train=True),
                             torch.from_numpy(batch["point_clouds"]))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    assert k9_calls == {"fwd": 0, "fwd_lse": TINY_CALLS, "bwd": TINY_CALLS}
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for (name, _), g in zip(trainable.items(), grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-9, (name, err)

    metrics = train_step(state, [_torch(batch)], cfg)
    assert k9_calls == {"fwd": 0, "fwd_lse": 2 * TINY_CALLS,
                        "bwd": 2 * TINY_CALLS}
    np.testing.assert_allclose(metrics["loss"], float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"], jnorm, rtol=1e-5)


@pytest.mark.parametrize("backend,dino", [
    ("short_legacy", None), ("short", None), ("flash", None), ("xla", None),
    (None, None), ("plain", "plain")])
def test_dinov2_stays_on_its_automatic_route(backend, dino):
    """The JAX model builds DinoViT without a backend; the port forwards
    only its own "plain" comparison switch to it."""
    model = MotionLatentModel(ModelConfig(**SMALL, attn_backend=backend),
                              seed=None)
    dino_blocks = model.image_encoder.model.blocks
    assert [b.attn.attn_backend for b in dino_blocks] == [dino] * len(dino_blocks)
    motion = [m.attn_backend for m in model.modules()
              if hasattr(m, "attn_backend") and not any(
                  m is b.attn for b in dino_blocks)]
    assert motion and set(motion) == {backend}
