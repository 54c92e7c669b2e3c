"""MotionPipeline of the port against the JAX package's, on the CPU:
examples/synthetic/blob.glb + blob.mp4 through the tiny model, the same
weights on both sides (JAX init converted by params_from_jax), exact f32
readback on the JAX side (u16_readback=False), the same uint8 upload and
host resize."""

import os

import jax
import numpy as np
import pytest

from motion324_tpu.inference.pipeline import MotionPipeline as JaxPipeline
from motion324_tpu.io.glb import load_animated_glb as jax_load_animated_glb
from motion324_tpu.io.mesh import load_mesh as jax_load_mesh
from motion324_tpu.inference.pipeline import (
    prepare_mesh_inputs as jax_prepare_mesh_inputs)
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.pipeline import (MotionPipeline,
                                                    _border_segment, load_video,
                                                    prepare_mesh_inputs)
from motion324_tpu_torch.io.glb import load_animated_glb
from motion324_tpu_torch.io.mesh import load_mesh
from motion324_tpu_torch.utils.convert import params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples", "synthetic")
MESH = os.path.join(ROOT, "blob.glb")
VIDEO = os.path.join(ROOT, "blob.mp4")

# as tests/test_pipeline.py runs the JAX pipeline
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=3, image_size=28, patch_size=14,
             drop_rate=0.0, dino_depth=1, dino_heads=3)
# f32 on both sides; trajectories are O(1) and agree to ~1e-6 in practice
TOL = 1e-4


@pytest.fixture(scope="module")
def pipelines():
    inputs, _, _ = jax_prepare_mesh_inputs(jax_load_mesh(MESH), 64)
    sample = dict(inputs, rgb_video=np.zeros((1, 3, 28, 28, 3), np.float32))
    params = JaxModel(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0), sample)
    r = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(params))
    jp = JaxPipeline(JaxConfig(**SMALL), params, window=3, decode_chunk=16,
                     u16_readback=False)
    tp = MotionPipeline(ModelConfig(**SMALL), state_dict=params_from_jax(params),
                        window=3, decode_chunk=16, device="cpu")
    return jp, tp


def test_mesh_inputs_match():
    want, _, _ = jax_prepare_mesh_inputs(jax_load_mesh(MESH), 256)
    got, _, _ = prepare_mesh_inputs(load_mesh(MESH), 256)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_border_segment_matches():
    import jax.numpy as jnp
    import torch
    from motion324_tpu.inference.pipeline import _border_segment as jax_seg
    x = load_video(VIDEO, max_frames=4, resize_to=28)[None]
    want = np.asarray(jax_seg(jnp.asarray(x)))
    got = _border_segment(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("segment", [False, True])
def test_predict_matches_jax(pipelines, segment):
    """Sliding windows over 7 frames (window 3), decode chunks of 16 over
    the 162 vertices."""
    jp, tp = pipelines
    inputs, _, _ = prepare_mesh_inputs(load_mesh(MESH), 64)
    video = load_video(VIDEO, max_frames=7, dtype=np.uint8, resize_to=28)
    want = jp.predict(inputs, video, segment=segment)
    got = tp.predict(inputs, video, segment=segment)
    assert got.shape == want.shape == (1, 7, 162, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_run_matches_jax(pipelines, tmp_path):
    """The product path end to end: both GLBs hold the same animation, and
    the port's GLB loads with the port's own loader."""
    jp, tp = pipelines
    want_path = jp.run(MESH, VIDEO, str(tmp_path / "jax"), num_shape_samples=64)
    got_path = tp.run(MESH, VIDEO, str(tmp_path / "port"), num_shape_samples=64)
    base, faces, frames, times = load_animated_glb(got_path)
    wbase, wfaces, wframes, wtimes = jax_load_animated_glb(want_path)
    assert frames.shape == (16, 162, 3) and np.isfinite(frames).all()
    np.testing.assert_array_equal(faces, wfaces)
    np.testing.assert_array_equal(times, wtimes)
    np.testing.assert_allclose(base, wbase, atol=1e-6)
    np.testing.assert_allclose(frames, wframes, atol=TOL, rtol=TOL)


def test_npy_video_input(pipelines, tmp_path):
    """A .npy array of frames (no codec) gives the same result as the
    decoded mp4 it was saved from."""
    _, tp = pipelines
    frames = load_video(VIDEO, dtype=np.uint8)
    np.save(tmp_path / "clip.npy", frames)
    a = tp.run(MESH, str(tmp_path / "clip.npy"), str(tmp_path / "a"),
               num_shape_samples=64)
    b = tp.run(MESH, VIDEO, str(tmp_path / "b"), num_shape_samples=64)
    np.testing.assert_array_equal(load_animated_glb(a)[2], load_animated_glb(b)[2])


def test_load_video_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        load_video(str(tmp_path / "frame.png"))
    np.save(tmp_path / "flat.npy", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="T, H, W"):
        load_video(str(tmp_path / "flat.npy"))


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    """The CLI with a tiny YAML model, random seeded weights and a .npy
    clip, on the CPU: it writes a GLB with one frame per input frame."""
    from motion324_tpu_torch import cli
    model = "".join(f"  {k}: {v}\n" for k, v in SMALL.items() if k != "frames")
    (tmp_path / "tiny.yaml").write_text(
        f"model:\n{model}  use_qk_norm: true\n  dtype: float32\n"
        f"training:\n  frames: {SMALL['frames']}\n")
    np.save(tmp_path / "clip.npy", load_video(VIDEO, max_frames=5,
                                              dtype=np.uint8))
    assert cli.main(["--mesh", MESH, "--video", str(tmp_path / "clip.npy"),
                     "--output", str(tmp_path / "out"), "--device", "cpu",
                     "--config", str(tmp_path / "tiny.yaml")]) == 0
    _, _, frames, _ = load_animated_glb(str(tmp_path / "out" /
                                            "output_animation.glb"))
    assert frames.shape == (5, 162, 3) and np.isfinite(frames).all()


@pytest.mark.parametrize("total,chunk", [(5, 12), (12, 12), (16, 12), (23, 12),
                                         (7, 3), (10, 4), (33, 32)])
def test_sliding_windows_match_jax(total, chunk):
    """The port's windowing copy stitches the same frames as the JAX one:
    each frame's trajectory carries its source window and frame index."""
    from motion324_tpu.inference.windowing import (
        sliding_window_predict as jax_windows)
    from motion324_tpu_torch.inference.windowing import sliding_window_predict
    video = np.arange(total, dtype=np.float32).reshape(total, 1, 1, 1)
    ref = np.full((1, 2, 3), -1.0, np.float32)
    calls = []

    def forward(window):
        calls.append(1)
        idx = window[:, 0, 0, 0]
        out = np.stack([idx, np.full_like(idx, len(calls)), idx * 0], -1)
        return np.broadcast_to(out[None, :, None, :], (1, len(idx), 2, 3))

    want = jax_windows(forward, video, chunk, ref)
    calls.clear()
    got = sliding_window_predict(forward, video, chunk, ref)
    assert got.shape == want.shape == (1, total, 2, 3)
    np.testing.assert_array_equal(got, want)
