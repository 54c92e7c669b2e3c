"""The port's data- and tensor-parallel train step in two gloo processes,
against the JAX package's sharded steps on the virtual CPU mesh.

Two port processes (tests/torch_parallel_workers.py, no JAX) take one step
each case while the JAX steps run here: the ``shard_map`` step on a
``(dp=2, mp=1)`` mesh with two micro-batches (with and without the bf16
all-reduce) and the ``gspmd`` step on a ``(1, 2)`` mesh. Both sides start
from the same JAX ``init`` (DINOv2's LayerScale drawn from U(0.1, 1) so
that its sharded attention reaches the output) with ``drop_rate 0``, in f32,
and are held to the tolerances of tests/test_torch_train_step.py. The
width has 4 heads (``feat_dim`` 48 of 12), so that ``mp=2`` splits them.
Two more cases drive ``Trainer`` with position dropout (rate 0.5) for two
steps: at ``mp=2`` with a different batch on each rank, against one process
fed rank 0's batches, and at ``dp=2`` with the same batches on both ranks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from motion324_tpu.config import load_config
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.parallel.mesh import batch_sharding, make_mesh
from motion324_tpu.training import optimizer as jax_opt
from motion324_tpu.training.train_step import TrainState as JaxState
from motion324_tpu.training.train_step import build_train_step
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.training.checkpoints import (auto_resume,
                                                      save_checkpoint)
from motion324_tpu_torch.training.train_step import (create_train_state,
                                                     train_step)
from motion324_tpu_torch.training.trainer import Trainer
from motion324_tpu_torch.utils.convert import params_from_jax
from test_torch_train_step import BASE, LOSS_TOL, PARAM_TOL, YAML, _batch

TP_SMALL = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
                head_dim=12, frames=2, image_size=28, patch_size=14,
                drop_rate=0.0, dino_depth=1, dino_heads=4)
ACCUM2 = [o for o in BASE if "grad_accum" not in o] + ["training.grad_accum_steps=2"]
DROP = dict(TP_SMALL, drop_rate=0.5)
OVERRIDES = {"dp": ACCUM2, "dp_bf16": ACCUM2 + ["training.bf16_grad_allreduce=true"],
             "tp": BASE + ["training.parallel_mode=gspmd", "mesh.mp=2"]}


def _layer_scale(params):
    """DINOv2's LayerScale from U(0.1, 1) instead of its 1e-5 init."""
    r = np.random.RandomState(5)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 + 0.9 * r.rand(*x.shape)).astype(np.float32)
        if str(path[-1]).strip("[]'").endswith("gamma") else x, params)


def _jax_step(model, params, over, mesh, batch, mode="shard_map"):
    cfg = load_config(YAML, over)
    tx, _ = jax_opt.create_optimizer(cfg)
    step = build_train_step(model, tx, cfg, mesh, mode=mode)
    state = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    if mode == "gspmd":
        state = jax.device_put(state, step.state_shardings(state))
        batch = jax.device_put(batch, batch_sharding(mesh))
    state, m = step(state, batch, jax.random.PRNGKey(0))
    return (params_from_jax(jax.tree.map(np.asarray, state.params)),
            {k: float(v) for k, v in m.items()})


def _trainer_cfg(over, tmp, name):
    return load_train_config(YAML, over + [
        f"training.checkpoint_dir={os.path.join(tmp, name)}"])


def _one_trainer(batches, tmp):
    """Two ``Trainer`` steps in one process with position dropout; the
    parameters and each forward's dropout mask."""
    cfg = ModelConfig(**DROP)
    trainer = Trainer(_trainer_cfg(BASE, tmp, "trainer_one"), cfg, batches,
                      device="cpu")
    masks = []
    trainer.state.model.transformer_input_layernorm.register_forward_pre_hook(
        lambda mod, args: masks.append(args[0][:, :, -cfg.grid ** 2:] == 0))
    state = trainer.train(2)
    return state.model.state_dict(), masks


def _one_process(params, over, micros):
    model = MotionLatentModel(ModelConfig(**TP_SMALL), seed=None)
    model.load_state_dict(params)
    cfg = load_train_config(YAML, over)
    state = create_train_state(model, cfg)
    m = train_step(state, [{k: torch.from_numpy(v) for k, v in mb.items()}
                           for mb in micros], cfg)
    return state, m, cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_train"))
    model = JaxModel(JaxConfig(**TP_SMALL))
    params = _layer_scale(jax.tree.map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1), _batch(0))))
    port = params_from_jax(params)
    micros = [_batch(4), _batch(5)]        # two micro-batches of 2 clips
    one = [_batch(6)]                      # one batch of 2 clips
    nan = [_batch(7), _batch(8)]
    mcfg = ModelConfig(**TP_SMALL)
    # a one-process checkpoint for the workers to resume at mp=2
    ckpt = {d: os.path.join(tmp, d) for d in ("one", "again", "after")}
    state, _, _ = _one_process(port, BASE, one)
    save_checkpoint(ckpt["one"], state)
    resumed = {k: v.clone() for k, v in state.model.state_dict().items()}

    case = lambda over, batches, mesh, **kw: dict(
        kind="train", model_cfg=mcfg, params=port, micros=batches, mesh=mesh,
        cfg=load_train_config(YAML, over), **kw)
    cases = {"dp": case(OVERRIDES["dp"], micros, (2, 1)),
             "dp_bf16": case(OVERRIDES["dp_bf16"], micros, (2, 1)),
             "dp_nan": case(OVERRIDES["dp"], nan, (2, 1), nan_rank=1),
             "tp": case(OVERRIDES["tp"], one, (1, 2)),
             "ckpt": dict(case(OVERRIDES["tp"], one, (1, 2)), kind="checkpoint",
                          params=resumed, resume=ckpt["one"],
                          again=ckpt["again"], after=ckpt["after"])}
    own = [[_batch(20), _batch(21)], [_batch(30), _batch(31)]]
    for name, over, mesh, batches in (
            ("trainer_tp", OVERRIDES["tp"], (1, 2), own),
            ("trainer_dp", BASE, (2, 1), [own[0], own[0]])):
        cases[name] = dict(kind="trainer", model_cfg=ModelConfig(**DROP),
                           mesh=mesh, steps=2, batches=batches,
                           cfg=_trainer_cfg(over, tmp, name))
    procs = workers.start({"cases": cases}, os.path.join(tmp, "workers"))

    stacked = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    mesh_dp = make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    mesh_tp = make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    want = {"dp": _jax_step(model, params, OVERRIDES["dp"], mesh_dp, stacked),
            "dp_bf16": _jax_step(model, params, OVERRIDES["dp_bf16"], mesh_dp,
                                 stacked),
            "tp": _jax_step(model, params, OVERRIDES["tp"], mesh_tp, one[0],
                            mode="gspmd")}
    trainer_one = _one_trainer(own[0], tmp)
    got = workers.results(procs, os.path.join(tmp, "workers"))
    return dict(got=got, want=want, port=port, one=one, ckpt=ckpt,
                resumed=state, trainer_one=trainer_one)


def _close(got: dict, want: dict, tol=PARAM_TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["dp", "dp_bf16"])
def test_dp_step_matches_jax_shard_map(runs, case):
    want_params, want = runs["want"][case]
    for r in runs["got"]:
        m = r[case]["metrics"]
        np.testing.assert_allclose(m["loss"], want["loss"], rtol=LOSS_TOL)
        # the bf16 wire rounds each gradient to 8 bits before the norm
        np.testing.assert_allclose(m["grad_norm"], want["grad_norm"],
                                   rtol=LOSS_TOL if case == "dp" else 1e-2)
        assert m["skipped"] == want["skipped"] == 0.0
        _close(r[case]["params"], want_params)
    a, b = (r[case]["params"] for r in runs["got"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_nan_on_one_rank_skips_on_both(runs):
    for r in runs["got"]:
        res = r["dp_nan"]
        assert res["metrics"]["skipped"] == 1.0
        assert (res["step"], res["update_step"]) == (1, 0)
        assert res["unchanged"]


def test_tp_step_matches_jax_gspmd_and_one_process(runs):
    want_params, want = runs["want"]["tp"]
    for r in runs["got"]:
        m = r["tp"]["metrics"]
        np.testing.assert_allclose(m["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"], want["grad_norm"],
                                   rtol=LOSS_TOL)
        _close(r["tp"]["params"], want_params)
        assert r["tp"]["replicated_equal"]
    state, m, _ = _one_process(runs["port"], BASE, runs["one"])
    np.testing.assert_allclose(runs["got"][0]["tp"]["metrics"]["grad_norm"],
                               m["grad_norm"], rtol=LOSS_TOL)
    _close(runs["got"][0]["tp"]["params"], state.model.state_dict())


def test_checkpoints_move_between_mp2_and_one_process(runs):
    """A one-process checkpoint resumes at mp=2 and is written back whole
    and unchanged; the step after it, written at mp=2, resumes in one
    process and equals that process's own step."""
    got = runs["got"][0]["ckpt"]
    assert got["resumed"] == os.path.join(runs["ckpt"]["one"],
                                          os.path.basename(got["again"]))
    one = torch.load(os.path.join(got["resumed"], "state.pt"))
    again = torch.load(os.path.join(got["again"], "state.pt"))
    assert (again["step"], again["update_step"]) == (one["step"], one["update_step"])
    for k, v in one["params"].items():
        assert torch.equal(again["params"][k], v), k
    for i, s in one["opt_state"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again["opt_state"]["state"][i][m], s[m]), (i, m)

    state = runs["resumed"]
    train_step(state, [{k: torch.from_numpy(v) for k, v in runs["one"][0].items()}],
               load_train_config(YAML, OVERRIDES["tp"]))
    _close(got["params"], state.model.state_dict())
    fresh, _, cfg = _one_process(runs["port"], BASE, runs["one"])
    fresh, found = auto_resume(runs["ckpt"]["after"], fresh)
    assert found == got["after"]
    assert (fresh.step, fresh.update_step) == (2, 2)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, got["params"][k]), k


def test_trainer_tp_ranks_take_one_batch_and_one_dropout_mask(runs):
    """Fed different batches, the two ranks of a TP replica train on rank
    0's (the Trainer broadcasts it) under the same dropout masks: their
    replicated parameters stay bit-equal and the gathered state is one
    process's on rank 0's batches."""
    a, b = (r["trainer_tp"] for r in runs["got"])
    one, one_masks = runs["trainer_one"]
    assert a["step"] == b["step"] == 2
    assert len(a["masks"]) == len(one_masks) == 2
    for x, y, z in zip(a["masks"], b["masks"], one_masks):
        assert 0 < int(x.sum()) < x.numel()
        assert torch.equal(x, y) and torch.equal(x, z)
    assert a["replicated_equal"] and b["replicated_equal"]
    _close(a["params"], one)


def test_trainer_dp_ranks_draw_their_own_dropout_masks(runs):
    """Fed the same batches, the two DP ranks draw different dropout masks
    (the dp index is folded into the seed) and end with the same
    parameters."""
    a, b = (r["trainer_dp"] for r in runs["got"])
    assert len(a["masks"]) == len(b["masks"]) == 2
    for x, y in zip(a["masks"], b["masks"]):
        assert not torch.equal(x, y)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_workers_load_no_jax(runs):
    assert [r["jax_loaded"] for r in runs["got"]] == [[], []]
