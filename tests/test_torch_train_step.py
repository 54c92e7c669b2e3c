"""The port's training step against the JAX package's, on the CPU in f32.

Both sides start from the same JAX ``init`` (converted with
``params_from_jax``) and the same numpy batch, at the tiny ``SMALL`` width of
tests/test_train_step.py, with ``drop_rate 0`` (the two frameworks' dropout
streams cannot match). JAX runs its ``shard_map`` step on a one-device mesh.
Gradients are compared parameter by parameter: AdamW's first update is
close to ``lr * sign(g)`` and would hide a wrong gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motion324_tpu.config import load_config
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.parallel.mesh import make_mesh
from motion324_tpu.training import optimizer as jax_opt
from motion324_tpu.training.loss import coord_mse_loss as jax_loss
from motion324_tpu.training.train_step import TrainState as JaxState
from motion324_tpu.training.train_step import build_train_step
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.training.loss import coord_mse_loss
from motion324_tpu_torch.training.optimizer import decays, lr_at
from motion324_tpu_torch.training.train_step import (check_parallel,
                                                     create_train_state,
                                                     train_step)
from motion324_tpu_torch.utils.convert import params_from_jax

YAML = "configs/dyscene.yaml"
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=2, image_size=28, patch_size=14, drop_rate=0.0,
             dino_depth=1, dino_heads=3)
BASE = ["training.warmup=0", "training.train_steps=100", "training.lr=1e-3",
        "training.grad_accum_steps=1", "training.allowed_gradnorm_factor=1e9",
        "training.remat=false"]

# f32 on both sides. Loss and gradients agree to ~1e-6 of their scale
# (the forward alone to ~2e-6, tests/test_torch_model.py); gradients are held
# per parameter to 1e-4 of that parameter's max |g|. Parameters after AdamW
# updates at lr 1e-3: an element whose gradient is within rounding of 0 may
# take the opposite sign(g) step on the two sides, so they are held to
# 2e-5 absolute, far below one update of 1e-3.
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 2e-5


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
def init():
    model = JaxModel(JaxConfig(**SMALL))
    params = model.init(jax.random.PRNGKey(1), _batch(0))
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(dp=1, mp=1, devices=jax.devices()[:1])


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state(params, over):
    model = MotionLatentModel(ModelConfig(**SMALL), seed=None)
    model.load_state_dict(params_from_jax(params))
    cfg = load_train_config(YAML, over)
    return create_train_state(model, cfg), cfg


def _jax_steps(init, mesh, over, batches):
    """Run the JAX step over ``batches``; returns (params, metrics list)."""
    model, params = init
    cfg = load_config(YAML, over)
    tx, _ = jax_opt.create_optimizer(cfg)
    step = build_train_step(model, tx, cfg, mesh)
    state = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    metrics = []
    for b in batches:
        state, m = step(state, b, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state.params), metrics, state


def _assert_params_close(model, jax_params, tol=PARAM_TOL):
    want = params_from_jax(jax_params)
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol,
                                   rtol=0, err_msg=name)


def test_loss_grad_norm_and_per_parameter_grads(init, mesh):
    model, params = init
    batch = _batch(1)

    def loss_fn(p):
        pred = model.apply(p, batch, train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss(pred, batch["point_clouds"])[0]
    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    jnorm = float(optax.global_norm(jgrads))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))

    state, cfg = _port_state(params, BASE)
    trainable = {n: p for n, p in state.model.named_parameters() if p.requires_grad}
    loss, _ = coord_mse_loss(state.model(_torch(batch), train=True),
                             torch.from_numpy(batch["point_clouds"]))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    for (name, _), g in zip(trainable.items(), grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-9, (name, err, np.abs(w).max())
    # the frozen encoder: no gradient on the port's side, zeros on JAX's
    for name, w in want.items():
        if name.startswith("image_encoder."):
            assert name not in trainable and not w.abs().max() > 0, name

    metrics = train_step(state, [_torch(batch)], cfg)
    _, jm, _ = _jax_steps(init, mesh, BASE, [batch])
    np.testing.assert_allclose(metrics["loss"], jm[0]["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"], jnorm, rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"], jm[0]["grad_norm"],
                               rtol=LOSS_TOL)
    assert metrics["skipped"] == jm[0]["skipped"] == 0.0


@pytest.mark.parametrize("extra", [[], ["training.bf16_grad_allreduce=true"]],
                         ids=["plain", "bf16_grad_round_trip"])
def test_params_after_two_updates(init, mesh, extra):
    """The test batches' gradient norms are 4-8, so the clip to 1.0 is
    active in both steps."""
    over = BASE + extra
    batches = [_batch(2), _batch(3)]
    jparams, jm, _ = _jax_steps(init, mesh, over, batches)
    state, cfg = _port_state(init[1], over)
    for b, want in zip(batches, jm):
        m = train_step(state, [_torch(b)], cfg)
        np.testing.assert_allclose(m["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"], want["grad_norm"], rtol=LOSS_TOL)
    assert (state.step, state.update_step) == (2, 2)
    _assert_params_close(state.model, jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accumulation_over_two_micro_batches(init, mesh, dtype):
    over = [o for o in BASE if "grad_accum" not in o] + [
        "training.grad_accum_steps=2", f"training.grad_accum_dtype={dtype}"]
    micros = [_batch(4), _batch(5)]
    stacked = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    jparams, jm, _ = _jax_steps(init, mesh, over, [stacked])
    state, cfg = _port_state(init[1], over)
    m = train_step(state, [_torch(b) for b in micros], cfg)
    np.testing.assert_allclose(m["loss"], jm[0]["loss"], rtol=LOSS_TOL)
    # bf16 accumulation rounds each micro-batch's gradient to 8 bits
    rtol = LOSS_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(m["grad_norm"], jm[0]["grad_norm"], rtol=rtol)
    _assert_params_close(state.model, jparams)


@pytest.mark.parametrize("fault", ["nan", "spike"])
def test_skipped_step_freezes_params_and_update_count(init, mesh, fault):
    """A NaN batch or a gradient spike skips the update: parameters, AdamW
    state and update_step stay, step advances. The next step's rate is read
    at the number of applied updates, as optax's count is: the sequence
    (skip, update, update) with warmup 3 matches the JAX step's."""
    over = [o for o in BASE if "warmup" not in o and "gradnorm" not in o] + [
        "training.warmup=3", "training.allowed_gradnorm_factor=100"]
    bad = _batch(6)
    if fault == "nan":
        bad["rgb_video"][0] = np.nan
    else:   # a norm far above 100 x clip; the good batches' are 4-8
        bad["point_clouds"] = bad["point_clouds"] * 1e4
    state, cfg = _port_state(init[1], over)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = train_step(state, [_torch(bad)], cfg)
    assert m["skipped"] == 1.0
    assert (state.step, state.update_step) == (1, 0)
    assert not state.optimizer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k

    good = [_batch(7), _batch(8)]
    for b in good:
        assert train_step(state, [_torch(b)], cfg)["skipped"] == 0.0
    assert (state.step, state.update_step) == (3, 2)
    jparams, jm, jstate = _jax_steps(init, mesh, over, [bad] + good)
    assert [x["skipped"] for x in jm] == [1.0, 0.0, 0.0]
    assert (int(jstate.step), int(jstate.update_step)) == (3, 2)
    _assert_params_close(state.model, jparams)


def test_frozen_encoder(init):
    state, cfg = _port_state(init[1], BASE)
    enc = {n: p.detach().clone() for n, p in state.model.named_parameters()
           if n.startswith("image_encoder.")}
    assert enc
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for n, p in state.model.named_parameters():
        assert (id(p) in in_opt) == (not n.startswith("image_encoder.")), n
        assert p.requires_grad == (not n.startswith("image_encoder.")), n
    train_step(state, [_torch(_batch(9))], cfg)
    for n, p in state.model.named_parameters():
        if n in enc:
            assert torch.equal(p, enc[n]), n


@pytest.mark.parametrize("warmup,total", [(1000, 30000), (0, 100), (5, 5)])
def test_schedule_matches_jax(warmup, total):
    sched = jax_opt.create_lr_schedule(4e-4, warmup, total)
    for step in (0, 1, warmup // 2, max(warmup - 1, 0), warmup, warmup + 1,
                 (warmup + total) // 2, total - 1, total, total + 10):
        # JAX evaluates in f32, the port in double: a few f32 ulps of 4e-4
        np.testing.assert_allclose(lr_at(step, 4e-4, warmup, total),
                                   float(sched(step)), rtol=1e-6, atol=1e-10)


def test_decay_set_matches_jax_decay_mask(init):
    """The port's decay set, mapped through the name map, is JAX's
    ``decay_mask`` (the frozen encoder decays on neither side)."""
    _, params = init
    mask = params_from_jax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), m, np.float32),
        jax_opt.decay_mask(params), params))
    model = MotionLatentModel(ModelConfig(**SMALL), seed=None)
    named = dict(model.named_parameters())
    assert set(mask) == set(named)
    for name, m in mask.items():
        assert decays(name, named[name]) == bool(m.flatten()[0]), name
        assert m.min() == m.max(), name


def test_remat_keeps_the_numbers(init):
    """Block recomputation changes memory, not the gradients."""
    batch = _torch(_batch(10))
    out = []
    for remat in (False, True):
        state, cfg = _port_state(init[1], BASE)
        state.model.remat = remat
        loss, _ = coord_mse_loss(state.model(batch, train=True),
                                 batch["point_clouds"])
        params = [p for p in state.model.parameters() if p.requires_grad]
        out.append(torch.autograd.grad(loss, params))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_is_drawn_from_the_generator(init):
    """train=True with drop_rate > 0: the same generator seed gives the same
    output, another seed another one; eval mode uses no mask."""
    model = MotionLatentModel(ModelConfig(**{**SMALL, "drop_rate": 0.5}), seed=0)
    batch = _torch(_batch(11))
    run = lambda seed: model(batch, train=True,
                             generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
        assert not torch.equal(run(0), run(1))
        torch.testing.assert_close(model(batch), model(batch, train=False))


@pytest.mark.parametrize("over", [["training.parallel_mode=gspmd", "mesh.mp=2"],
                                  ["mesh.dp=2"]])
def test_other_modes_name_the_roadmap_item(over):
    """A tensor- or data-parallel mesh of two ranks, without a process
    group of that size, names the world size it needs."""
    cfg = load_train_config(YAML, over)
    with pytest.raises(ValueError, match="needs a world size .*2"):
        check_parallel(cfg)
