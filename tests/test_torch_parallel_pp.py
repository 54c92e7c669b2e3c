"""The port's pipeline parallelism in two gloo processes, against the JAX
package's GPipe programs on the virtual CPU mesh and against one process.

Two port processes (tests/torch_parallel_workers.py, no JAX) hold a stage
of the alternating stack each (tests/test_pp.py's ``SMALL``: 4 pairs, 2 a
stage) and run ``MotionPipeline(parallel="pp").predict`` and one
``train_step`` with ``parallel_mode="pp"`` at ``pp_microbatches`` 1 and 2,
while JAX runs ``MotionPipeline(parallel="pp")`` and ``_build_pp_step`` on a
``(dp=1, mp=2)`` mesh. Both sides start from the same JAX ``init`` (DINOv2's
LayerScale drawn from U(0.1, 1)) in f32 with ``drop_rate 0``. Trajectories
are held to 1e-4 x max|traj|, losses and grad norms to 1e-5 relative.
Each parameter's gradient (AdamW's first moment, from the PP=2 step's
whole checkpoint) is held to 1e-4 of its max |g| against one process's,
and every parameter after the step to 2e-5 (tests/
test_torch_train_step.py's limits) wherever its gradient exceeds 1e-6:
within about 100 x AdamW's eps of 0 the first update ``lr g / (|g| +
eps)`` follows the gradient's last bits (one element in 3e4 moved 4e-5
at lr 1e-3 against JAX at this width). A checkpoint written at PP=2
resumes in one process, and a one-process checkpoint at PP=2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from motion324_tpu.config import load_config
from motion324_tpu.inference.pipeline import MotionPipeline as JaxPipeline
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.parallel.mesh import batch_sharding, make_mesh
from motion324_tpu.training import optimizer as jax_opt
from motion324_tpu.training.train_step import TrainState as JaxState
from motion324_tpu.training.train_step import build_train_step
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.inference.pipeline import MotionPipeline
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.training.checkpoints import (auto_resume,
                                                      latest_checkpoint,
                                                      save_checkpoint)
from motion324_tpu_torch.training.train_step import (create_train_state,
                                                     train_step)
from motion324_tpu_torch.utils.convert import params_from_jax
from test_pp import SMALL, _batch
from test_torch_parallel_infer import TRAJ_REL, _inputs, _video
from test_torch_parallel_train import _layer_scale
from test_torch_train_step import BASE, GRAD_REL, LOSS_TOL, PARAM_TOL, YAML

CFG = {f: getattr(SMALL, f) for f in (
    "feat_dim", "tokens", "pcd_layers", "n_alternating_layers", "head_dim",
    "frames", "image_size", "patch_size", "drop_rate", "dino_depth",
    "dino_heads")}
MICRO = (1, 2)
SETTLED = 1e-6   # |g| above which AdamW's first update is stable


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(m: int) -> list[str]:
    return BASE + ["training.parallel_mode=pp", "mesh.mp=2",
                   f"training.pp_microbatches={m}"]


def _np_batch(b=2) -> dict:
    return {k: np.asarray(v) for k, v in _batch(jax.random.PRNGKey(0), b).items()}


def _jax_step(params, batch, m):
    """JAX's ``_build_pp_step`` on a (1, 2) mesh: whole params, metrics."""
    cfg = load_config(YAML, _over(m))
    tx, _ = jax_opt.create_optimizer(cfg)
    mesh = make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    model = JaxModel(dataclasses.replace(SMALL, pp_axis="mp", pp_size=2,
                                         pp_microbatches=m))
    step = build_train_step(model, tx, cfg, mesh, mode="pp")
    state = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    state = jax.device_put(state, step.state_shardings(state))
    state, metrics = step(state, jax.device_put(batch, batch_sharding(mesh)),
                          jax.random.PRNGKey(0))
    return (params_from_jax(jax.tree.map(np.asarray, state.params)),
            {k: float(v) for k, v in metrics.items()})


def _one_process(port, batch, over=BASE):
    model = MotionLatentModel(ModelConfig(**CFG), seed=None)
    model.load_state_dict(port)
    cfg = load_train_config(YAML, over)
    state = create_train_state(model, cfg)
    metrics = train_step(state, [{k: torch.from_numpy(v)
                                  for k, v in batch.items()}], cfg)
    return state, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_pp"))
    batch = _np_batch()
    params = _layer_scale(jax.tree.map(
        np.asarray, jax.jit(JaxModel(SMALL).init)(jax.random.PRNGKey(1),
                                                  batch)))
    port = params_from_jax(params)
    mcfg = ModelConfig(**CFG)
    inputs, video = _inputs(1), _video(12, 4)
    ckpt = {d: os.path.join(tmp, d) for d in ("pp1", "pp2", "one", "again",
                                                "after")}
    one_state, _ = _one_process(port, batch)
    save_checkpoint(ckpt["one"], one_state)
    cases = {f"step_m{m}": dict(
        kind="train", model_cfg=mcfg, params=port, micros=[batch],
        mesh=(1, 2), cfg=load_train_config(YAML, _over(m)),
        save=ckpt[f"pp{m}"]) for m in MICRO}
    cases["ckpt"] = dict(kind="checkpoint", model_cfg=mcfg,
                         params=one_state.model.state_dict(), micros=[batch],
                         mesh=(1, 2), cfg=load_train_config(YAML, _over(1)),
                         resume=ckpt["one"], again=ckpt["again"],
                         after=ckpt["after"])
    cases["predict"] = dict(kind="predict", parallel="pp", window=2,
                            model_cfg=mcfg, params=port, inputs=inputs,
                            runs=[(video, False)])
    procs = workers.start({"cases": cases}, os.path.join(tmp, "workers"))

    want = {f"step_m{m}": _jax_step(params, batch, m) for m in MICRO}
    mesh = make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    want["predict"] = JaxPipeline(SMALL, params, window=2, decode_chunk=8,
                                  mesh=mesh, parallel="pp",
                                  u16_readback=False).predict(inputs, video)
    want["predict_one"] = MotionPipeline(mcfg, state_dict=port, window=2,
                                         decode_chunk=8, device="cpu"
                                         ).predict(inputs, video)
    got = workers.results(procs, os.path.join(tmp, "workers"))
    return dict(got=got, want=want, port=port, batch=batch, ckpt=ckpt,
                one_state=one_state, moments=_first_moments(ckpt["one"]))


def _first_moments(path: str) -> dict:
    """AdamW's first moment of each trainable parameter, by name, from the
    whole checkpoint in ``path`` (indexed as a one-process model's
    optimizer)."""
    from motion324_tpu_torch.training.checkpoints import _opt_names
    state = create_train_state(MotionLatentModel(ModelConfig(**CFG), seed=None),
                               load_train_config(YAML, BASE))
    names = _opt_names(state)
    saved = torch.load(os.path.join(latest_checkpoint(path), "state.pt"))
    saved = saved["opt_state"]["state"]
    return {names[int(i)]: s["exp_avg"] for i, s in saved.items()}


def _close(got: dict, want: dict, moments: dict):
    """Every entry within PARAM_TOL where the gradient (``moments``, a
    first moment; all of a frozen entry) has settled."""
    assert set(got) == set(want)
    for name, w in want.items():
        keep = (moments[name].abs() > 0.1 * SETTLED if name in moments
                else torch.ones_like(w, dtype=torch.bool))
        np.testing.assert_allclose(got[name][keep].numpy(), w[keep].numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_pp_predict_matches(runs, against):
    want = runs["want"]["predict" if against == "jax" else "predict_one"]
    for r in runs["got"]:
        got = r["predict"]["trajs"][0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TRAJ_REL * np.abs(want).max()


@pytest.mark.parametrize("m", MICRO)
def test_pp_step_matches_jax_pp_step(runs, m):
    want_params, want = runs["want"][f"step_m{m}"]
    for r in runs["got"]:
        res = r[f"step_m{m}"]
        np.testing.assert_allclose(res["metrics"]["loss"], want["loss"],
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(res["metrics"]["grad_norm"],
                                   want["grad_norm"], rtol=LOSS_TOL)
        assert res["metrics"]["skipped"] == want["skipped"] == 0.0
        assert res["replicated_equal"]
        _close(res["params"], want_params, runs["moments"])


def test_pp_step_matches_one_process(runs):
    fresh, m = _one_process(runs["port"], runs["batch"])
    for r in runs["got"]:
        got = r["step_m1"]
        np.testing.assert_allclose(got["metrics"]["loss"], m["loss"],
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], m["grad_norm"],
                                   rtol=LOSS_TOL)
        _close(got["params"], fresh.model.state_dict(), runs["moments"])


@pytest.mark.parametrize("m", MICRO)
def test_pp_gradients_match_one_process(runs, m):
    """Each parameter's first moment after the PP=2 step (the gradient,
    clipped, times 1 - beta1) against one process's."""
    got = _first_moments(runs["ckpt"][f"pp{m}"])
    want = runs["moments"]
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()) + 1e-12, (name, err)


def test_pp_checkpoint_resumes_in_one_process(runs):
    """The step at PP=2, written whole, resumes in one process: its
    parameters bit for bit and AdamW's moments those of one process's own
    step; a one-process checkpoint resumes at PP=2 and is written back
    unchanged."""
    saved = runs["got"][0]["step_m1"]["saved"]
    model = MotionLatentModel(ModelConfig(**CFG), seed=None)
    state = create_train_state(model, load_train_config(YAML, BASE))
    state, found = auto_resume(runs["ckpt"]["pp1"], state)
    assert found == saved and (state.step, state.update_step) == (1, 1)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, runs["got"][0]["step_m1"]["params"][k]), k
    one = runs["one_state"].optimizer.state_dict()["state"]
    for i, s in state.optimizer.state_dict()["state"].items():
        for mom in ("exp_avg", "exp_avg_sq"):
            want = one[i][mom].numpy()
            np.testing.assert_allclose(s[mom].numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{i} {mom}")
    got = runs["got"][0]["ckpt"]
    a = torch.load(os.path.join(got["again"], "state.pt"))
    b = torch.load(os.path.join(got["resumed"], "state.pt"))
    for k, v in b["params"].items():
        assert torch.equal(a["params"][k], v), k
    assert a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"]
    for i, s in b["opt_state"]["state"].items():
        for mom in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a["opt_state"]["state"][i][mom], s[mom]), (i, mom)


def test_workers_load_no_jax(runs):
    assert [r["jax_loaded"] for r in runs["got"]] == [[], []]
