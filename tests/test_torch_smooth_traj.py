"""Trajectory smoothing and the Blender remap on the device
(``ops/smooth_traj.py``, ``csrc/smooth_traj.cu``), the field kept on the
device through the window stitch, and the GLB writer that lays the morph
targets out as one block.

The plain version and the kernel are held to numpy's ``smooth_trajectories``
followed by ``to_blender_coords`` (the host route), the tensor stitch to the
numpy stitch, and the writer to the bytes the per-target writer wrote. Tests
marked ``cuda`` need the card and skip without one. This file imports no
JAX, so on a machine with only PyTorch run it with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_smooth_traj.py
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import motion324_tpu_torch.inference.pipeline as pipeline
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.pipeline import (MotionPipeline,
                                                    to_blender_coords)
from motion324_tpu_torch.inference.smoothing import smooth_trajectories
from motion324_tpu_torch.inference.windowing import sliding_window_predict
from motion324_tpu_torch.io.glb import (_read_chunks, export_animated_glb,
                                        load_animated_glb)
from motion324_tpu_torch.ops.smooth_traj import (METHODS, smooth_traj,
                                                 smooth_traj_reference)

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples", "synthetic")
THRESHOLD = 0.002
# the tiny model of tests/test_torch_pipeline.py
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=3, image_size=28, patch_size=14,
             drop_rate=0.0, dino_depth=1, dino_heads=3)


def field(seed: int, shape) -> np.ndarray:
    """A seeded ``(B, T, N, 3)`` f32 walk whose steps lie on both sides of
    the threshold: chains of still frames (no step), steps well below it,
    steps within 10% of it and steps far above it."""
    rng = np.random.default_rng(seed)
    b, t, n, _ = shape
    base = rng.normal(size=(b, 1, n, 3)) * 0.3
    direction = rng.normal(size=shape)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    kind = rng.integers(0, 4, size=(b, t, n, 1))
    size = np.choose(kind, [np.zeros((b, t, n, 1)),
                            rng.uniform(0, 0.5, (b, t, n, 1)),
                            rng.uniform(0.9, 1.1, (b, t, n, 1)),
                            rng.uniform(2, 20, (b, t, n, 1))]) * THRESHOLD
    return (base + np.cumsum(direction * size, axis=1)).astype(np.float32)


def host_route(trajs: np.ndarray, method: str) -> np.ndarray:
    """numpy's smoothing at the shipped threshold and sigma, then the remap."""
    if method != "none":
        trajs = smooth_trajectories(trajs, method=method,
                                    motion_threshold=THRESHOLD, sigma=1.0)
    return to_blender_coords(trajs)


def assert_within_ulp(got, want, method):
    """The freeze and the remap are exact; the Gaussian's one rounding of its
    f64 sum to f32 may differ by one ulp where a sum's terms are added in
    another order (an FMA in scipy's build)."""
    if method in ("none", "threshold"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


SHAPES = [(3, 17, 100, 3), (2, 6, 33, 3), (1, 1, 5, 3), (1, 40, 300, 3)]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_the_host_route(shape, method):
    a = field(7, shape)
    if shape[1] > 1:     # the field exercises both sides of the threshold
        steps = np.linalg.norm(np.diff(a, axis=1), axis=-1)
        assert 0.4 < (steps < THRESHOLD).mean() < 0.85
    got = smooth_traj_reference(torch.from_numpy(a), method, THRESHOLD, 1.0)
    assert got.dtype == torch.float32 and got.shape == shape
    assert_within_ulp(got.numpy(), host_route(a, method), method)


def test_plain_version_checks_its_input():
    a = torch.from_numpy(field(1, (1, 4, 8, 3)))
    for method in ("savgol", "oneeuro", "median"):
        with pytest.raises(ValueError):
            smooth_traj(a, method)
    with pytest.raises(TypeError):
        smooth_traj(a.double())
    for bad in (a[0], a[..., :2], a[:, :0]):
        with pytest.raises(ValueError):
            smooth_traj(bad)
    with pytest.raises(ValueError):
        smooth_traj(a, "gaussian", sigma=0.0)


@pytest.mark.parametrize("total,chunk", [(5, 12), (12, 12), (16, 12), (23, 12),
                                         (7, 3), (10, 4), (33, 32)])
def test_tensor_stitch_matches_the_numpy_stitch(total, chunk):
    """The window stitch on tensors (the model's output where it lies)
    takes the frames the numpy stitch takes: each frame's trajectory
    carries its source window and frame index."""
    video = np.arange(total, dtype=np.float32).reshape(total, 1, 1, 1)
    ref = np.full((1, 2, 3), -1.0, np.float32)
    calls = []

    def forward(window):
        calls.append(1)
        idx = window[:, 0, 0, 0]
        out = np.stack([idx, np.full_like(idx, len(calls)), idx * 0], -1)
        return np.broadcast_to(out[None, :, None, :], (1, len(idx), 2, 3))

    want = sliding_window_predict(forward, video, chunk, ref)
    calls.clear()
    got = sliding_window_predict(
        lambda w: torch.from_numpy(np.ascontiguousarray(forward(w))), video,
        chunk, ref)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def glb_inputs(t=7, n=41):
    """A seeded animated mesh with UVs, vertex colours and a texture; frame
    2 holds exact zeros and signed zeros, whose min and max depend on the
    order a reduction meets them."""
    rng = np.random.default_rng(1907)
    verts = rng.normal(size=(n, 3)).astype(np.float32)
    verts[0] = [0.0, -0.0, 0.0]
    faces = rng.integers(0, n, size=(2 * n, 3))
    uv = rng.random((n, 2), dtype=np.float32)
    colors = rng.random((n, 3), dtype=np.float32)
    tex = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    trajs = verts + np.cumsum(rng.normal(size=(t, n, 3)) * 0.05,
                              0).astype(np.float32)
    trajs[2] = verts
    trajs[2, 0] = [-0.0, -0.0, -0.0]
    return verts, faces, trajs, uv, tex, colors


# sha256 of the file the per-target writer (256 subtractions, per-target
# min / max, a joined buffer) wrote for glb_inputs()
GLB_SHA256 = "0594bf53873f7f9d3caf30df1dafd1f3c75e798524a446fc8478076db817a103"


def test_glb_writer_writes_the_same_bytes(tmp_path):
    verts, faces, trajs, uv, tex, colors = glb_inputs()
    path = str(tmp_path / "a.glb")
    export_animated_glb(path, verts, faces, trajs, fps=12, uv=uv, texture=tex,
                        vertex_colors=colors)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == GLB_SHA256
    base, got_faces, frames, times = load_animated_glb(path)
    np.testing.assert_array_equal(base, verts)
    np.testing.assert_array_equal(got_faces, faces)
    np.testing.assert_allclose(frames, trajs, atol=1e-6)
    np.testing.assert_allclose(times, np.arange(7) / 12, rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_glb_target_bounds_are_each_targets_own(tmp_path, seed):
    """Each morph target's accessor min and max are what numpy's reduction
    of that target alone gives, signed zeros included: targets full of +0,
    -0 and a few values of one sign, over a base at the origin (a reduction
    in another order gives other signs of zero on seeds 1 and 2)."""
    rng = np.random.default_rng(seed)
    t, n = 6, 4099
    disp = (np.abs(rng.normal(size=(t, n, 3)))
            * rng.integers(0, 2, (t, n, 3))).astype(np.float32)
    disp[rng.random((t, n, 3)) < 0.3] = -0.0
    disp[::2] *= -1
    disp[3] = 0.0
    disp[3, -1] = -0.0
    path = str(tmp_path / "z.glb")
    export_animated_glb(path, np.zeros((n, 3), np.float32),
                        np.zeros((1, 3), np.int64), disp)
    with open(path, "rb") as f:
        gltf, _ = _read_chunks(f.read())
    for i, target in enumerate(gltf["meshes"][0]["primitives"][0]["targets"]):
        acc = gltf["accessors"][target["POSITION"]]
        for key, want in (("min", disp[i].min(axis=0)),
                          ("max", disp[i].max(axis=0))):
            got = np.array(acc[key], np.float32)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def spy_exports(monkeypatch):
    """The trajectories each GLB export is handed, copied."""
    seen = []
    real = pipeline.export_animated_glb

    def export(path, vertices, faces, trajectories, **kw):
        seen.append(np.array(trajectories))
        return real(path, vertices, faces, trajectories, **kw)
    monkeypatch.setattr(pipeline, "export_animated_glb", export)
    return seen


def spy_fields(monkeypatch, pipe):
    """The raw fields :meth:`MotionPipeline._finish` is handed, on the host."""
    seen = []
    real = pipe._finish

    def finish(field, smooth):
        seen.append(field.cpu().numpy().copy())
        return real(field, smooth)
    monkeypatch.setattr(pipe, "_finish", finish)
    return seen


def clip(path, seed: int) -> str:
    """A seeded 5-frame uint8 clip at the tiny model's size, as ``.npy`` (a
    codec needs cv2, which the card's machine lacks)."""
    rng = np.random.default_rng(seed)
    np.save(path, rng.integers(0, 256, (5, 28, 28, 3), dtype=np.uint8))
    return str(path)


def run_and_compare(pipe, monkeypatch, tmp_path, smooth=True):
    """One ``run`` of the blob mesh and a seeded clip: returns the kernel's
    launches; every exported frame is held to the host route on the raw
    field."""
    exports = spy_exports(monkeypatch)
    fields = spy_fields(monkeypatch, pipe)
    before = smooth_traj.launches
    pipe.run(os.path.join(ROOT, "blob.glb"), clip(tmp_path / "clip.npy", 5),
             str(tmp_path / "out"), num_shape_samples=64, smooth=smooth)
    raw, = fields
    got, = exports
    want = host_route(raw, "combined" if smooth else "none")[0]
    assert_within_ulp(got, want, "combined" if smooth else "none")
    return smooth_traj.launches - before


@pytest.mark.parametrize("smooth", [True, False])
def test_run_on_the_cpu_takes_the_plain_version(monkeypatch, tmp_path, smooth):
    pipe = MotionPipeline(ModelConfig(**SMALL), window=3, decode_chunk=16,
                          device="cpu")
    assert run_and_compare(pipe, monkeypatch, tmp_path, smooth) == 0


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smoothing kernel is built with "
                    "nvcc and runs only on the card")
    return torch.device("cuda")


CARD_SHAPES = [(1, 256, 20164, 3), (3, 17, 1000, 3), (2, 6, 33, 3),
               (1, 1, 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_the_plain_version_and_the_host_route(cuda, shape):
    a = field(11, shape)
    x = torch.from_numpy(a).to(cuda)
    for method in METHODS:
        before = smooth_traj.launches
        got = smooth_traj(x, method, THRESHOLD, 1.0)
        torch.cuda.synchronize()
        assert smooth_traj.launches == before + 1
        assert got.device == x.device and got.shape == x.shape
        got = got.cpu().numpy()
        plain = smooth_traj_reference(torch.from_numpy(a), method, THRESHOLD,
                                      1.0).numpy()
        assert_within_ulp(got, plain, method)
        assert_within_ulp(got, host_route(a, method), method)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.from_numpy(field(3, (2, 9, 40, 3))).to(cuda)
    before = smooth_traj.launches
    with pytest.raises(TypeError):
        smooth_traj(x.double())
    with pytest.raises(TypeError):
        smooth_traj(x.half())
    with pytest.raises(ValueError):
        smooth_traj(x.transpose(1, 2))
    with pytest.raises(ValueError):
        smooth_traj(x[:, ::2])
    with pytest.raises(ValueError):
        smooth_traj(x, "savgol")
    with pytest.raises(ValueError):
        smooth_traj(x, "gaussian", sigma=3.0)    # radius 12 > 8
    assert smooth_traj.launches == before


def card_pipeline(cuda):
    return MotionPipeline(ModelConfig(**SMALL, attn_backend="plain"),
                          window=3, decode_chunk=16, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [True, False])
def test_run_launches_the_kernel_once_a_clip(cuda, monkeypatch, tmp_path,
                                             smooth):
    """``run`` on the card: one launch a clip, and the GLB's frames are the
    host route's on the same raw field."""
    pipe = card_pipeline(cuda)
    assert run_and_compare(pipe, monkeypatch, tmp_path, smooth) == 1


@pytest.mark.cuda
def test_run_batch_launches_the_kernel_once_for_its_clips(cuda, monkeypatch,
                                                          tmp_path):
    """``run_batch`` of two clips of one shape: one forward, one launch for
    both, and each GLB's frames are the host route's on its raw clip."""
    pipe = card_pipeline(cuda)
    exports = spy_exports(monkeypatch)
    fields = spy_fields(monkeypatch, pipe)
    before = smooth_traj.launches
    mesh = os.path.join(ROOT, "blob.glb")
    pipe.run_batch([(mesh, clip(tmp_path / f"{name}.npy", seed))
                    for seed, name in enumerate(("one", "two"))],
                   str(tmp_path / "out"), num_shape_samples=64)
    assert smooth_traj.launches == before + 1
    raw, = fields
    assert raw.shape[0] == 2 and len(exports) == 2
    want = host_route(raw, "combined")
    for i, got in enumerate(exports):
        assert_within_ulp(got, want[i], "combined")
