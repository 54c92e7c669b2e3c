"""The port's sequence- and tensor-parallel inference in two gloo processes,
against the JAX pipeline with ``mesh=make_mesh(dp=1, mp=2)`` and the same
``parallel`` on the virtual CPU mesh.

The port's ranks (tests/torch_parallel_workers.py, no JAX) each run
``MotionPipeline(parallel="sp" | "tp").predict`` and return the whole
trajectories; both sides load the same JAX ``init`` (DINOv2's LayerScale
drawn from U(0.1, 1)) in f32, the JAX side with f32 readback, and are held
to 1e-4 x max|traj|, the port's trajectory tolerance. SP runs at the width
of tests/test_sp.py (3 heads); TP at 4 heads, so that ``mp=2`` splits them.
"""

import os

import jax
import numpy as np
import pytest

import torch_parallel_workers as workers
from motion324_tpu.inference.pipeline import MotionPipeline as JaxPipeline
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.parallel.mesh import make_mesh
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.utils.convert import params_from_jax
from test_torch_parallel_train import TP_SMALL, _layer_scale

SMALL = dict(TP_SMALL, feat_dim=36, dino_heads=3)
TRAJ_REL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, n=8, s=16):
    r = np.random.RandomState(seed)
    return {
        "ref_shape_pcd": r.randn(1, s, 3).astype(np.float32),
        "ref_shape_normals": r.randn(1, s, 3).astype(np.float32),
        "ref_shape_rgbs": r.rand(1, s, 3).astype(np.float32),
        "ref_pcd": r.randn(1, n, 3).astype(np.float32),
        "ref_normal": r.randn(1, n, 3).astype(np.float32),
        "ref_rgb": r.rand(1, n, 3).astype(np.float32),
    }


def _video(seed, t, hw=28):
    """Frames in [0, 1] with a bright square on a dark border, so that the
    border segmentation keeps a foreground."""
    r = np.random.RandomState(seed)
    v = (0.1 * r.rand(t, hw, hw, 3)).astype(np.float32)
    v[:, 9:19, 9:19] = 0.5 + 0.5 * r.rand(t, 10, 10, 3)
    return v


def _params(cfg: dict, seed: int):
    model = JaxModel(JaxConfig(**cfg))
    sample = dict(_inputs(0), rgb_video=_video(0, 2)[None])
    return _layer_scale(jax.tree.map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(seed), sample)))


# (parallel, model width, window, runs of (frames, segment)); a clip
# shorter than the window runs whole
CASES = {
    "sp": ("sp", SMALL, 8, [(8, False), (8, True), (3, False)]),
    "sp_frame0": ("sp", SMALL, 2, [(2, False)]),
    "tp": ("tp", TP_SMALL, 4, [(4, False), (4, True)]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_infer"))
    inputs = _inputs(1)
    params = {"sp": _params(SMALL, 2), "tp": _params(TP_SMALL, 3)}
    videos = {t: _video(10 + t, t) for t in (2, 3, 4, 8)}
    video_path = os.path.join(tmp, "clip.npy")
    np.save(video_path, (videos[4] * 255).astype(np.uint8))
    cases = {}
    for name, (par, cfg, window, clips) in CASES.items():
        cases[name] = dict(kind="predict", parallel=par, window=window,
                           model_cfg=ModelConfig(**cfg),
                           params=params_from_jax(params[par]), inputs=inputs,
                           runs=[(videos[t], seg) for t, seg in clips])
    cases["tp"].update(glb=os.path.join(tmp, "glb"), video_path=video_path,
                       mesh_path=os.path.join(ROOT, "examples", "synthetic",
                                              "blob.glb"))
    cases["guard"] = dict(kind="window_guard", window=3,
                          model_cfg=ModelConfig(**SMALL))
    procs = workers.start({"cases": cases}, os.path.join(tmp, "workers"))

    mesh = make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    want = {}
    for name, (par, cfg, window, clips) in CASES.items():
        pipe = JaxPipeline(JaxConfig(**cfg), params[par], window=window,
                           decode_chunk=8, mesh=mesh, parallel=par,
                           u16_readback=False)
        want[name] = [pipe.predict(inputs, videos[t], segment=seg)
                      for t, seg in clips]
    with pytest.raises(ValueError, match="divisible") as guard:
        JaxPipeline(JaxConfig(**SMALL), params["sp"], window=3, mesh=mesh,
                    parallel="sp")
    want["guard"] = str(guard.value)
    return workers.results(procs, os.path.join(tmp, "workers")), want


def _assert_trajs(got, want):
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TRAJ_REL * scale, (err, scale)


@pytest.mark.parametrize("case,run", [
    ("sp", 0), ("sp", 1), ("sp", 2), ("sp_frame0", 0), ("tp", 0), ("tp", 1)],
    ids=["sp", "sp_border_segmentation", "sp_short_clip_replicated",
         "sp_frame0_token_and_pos_offset", "tp", "tp_border_segmentation"])
def test_predict_matches_jax_pipeline(runs, case, run):
    got, want = runs
    for rank in got:
        _assert_trajs(rank[case]["trajs"][run], want[case][run])
    if case == "sp_frame0":   # rank 1's frame is not a copy of frame 0's
        traj = got[0][case]["trajs"][0]
        assert not np.allclose(traj[:, 0], traj[:, 1])


def test_sp_window_guard(runs):
    got, want = runs
    for rank in got:
        assert rank["guard"]["error"] == want["guard"]


def test_only_rank_zero_writes_the_glb(runs):
    got, _ = runs
    assert [r["tp"]["wrote"] for r in got] == [["output_animation.glb"], []]


def test_workers_load_no_jax(runs):
    assert [r["jax_loaded"] for r in runs[0]] == [[], []]
