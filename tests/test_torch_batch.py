"""The port's batched inference and in-graph U2Net against the JAX
package's, on the CPU in f32: ``predict_batch`` and the ``"u2net"`` segment
mode against the JAX pipeline (exact f32 readback, ``u16_readback=False``,
the same uint8 upload), batched clips against the same clips alone,
``run_batch``'s grouping and GLB output, and the batch CLI's failure
handling.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.inference.pipeline import MotionPipeline as JaxPipeline
from motion324_tpu.inference.segmentation import U2Net as JaxU2Net
from motion324_tpu.io.glb import load_animated_glb as jax_load_animated_glb
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.utils.torch_convert import convert_u2net
from motion324_tpu_torch import batch_inference
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.pipeline import (MotionPipeline, build_u2net,
                                                    load_video,
                                                    prepare_mesh_inputs)
from motion324_tpu_torch.io.glb import load_animated_glb
from motion324_tpu_torch.io.mesh import load_mesh
from motion324_tpu_torch.utils.convert import params_from_jax
from test_torch_segmentation import _u2net_torch_sd

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples", "synthetic")
MESH = os.path.join(ROOT, "blob.glb")
VIDEO = os.path.join(ROOT, "blob.mp4")
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=3, image_size=28, patch_size=14,
             drop_rate=0.0, dino_depth=1, dino_heads=3)
# f32 on both sides, as tests/test_torch_pipeline.py holds predict
TOL = 1e-4
# the port against itself, batched against alone: the same kernels on
# stacked inputs; the CPU's matrix products may block a batch of 3 another
# way than a batch of 1
SELF_TOL = 1e-5

# an octahedron: a mesh with another vertex count than the blob's 162
OCTAHEDRON = """v 1 0 0\nv -1 0 0\nv 0 1 0\nv 0 -1 0\nv 0 0 1\nv 0 0 -1
f 1 3 5\nf 3 2 5\nf 2 4 5\nf 4 1 5\nf 3 1 6\nf 2 3 6\nf 4 2 6\nf 1 4 6
"""


@pytest.fixture(scope="module")
def weights():
    inputs, _, _ = prepare_mesh_inputs(load_mesh(MESH), 64)
    sample = dict(inputs, rgb_video=np.zeros((1, 3, 28, 28, 3), np.float32))
    params = JaxModel(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0), sample)
    r = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(params))


@pytest.fixture(scope="module")
def u2net_sd():
    return _u2net_torch_sd(np.random.RandomState(3))


@pytest.fixture(scope="module")
def pipelines(weights, u2net_sd):
    """The JAX pipeline with its in-graph U2Net in f32 (the JAX package
    commits it in bf16; f32 on both sides keeps the masks identical), and
    the port's with the same weights, its U2Net swapped for an f32 one."""
    jp = JaxPipeline(JaxConfig(**SMALL), weights, window=3, decode_chunk=16,
                     u16_readback=False)
    jp._seg = (JaxU2Net(dtype=jnp.float32), convert_u2net(u2net_sd))
    sd = {k: torch.from_numpy(v) for k, v in u2net_sd.items()}
    tp = MotionPipeline(ModelConfig(**SMALL), state_dict=params_from_jax(weights),
                        window=3, decode_chunk=16, device="cpu", seg_params=sd)
    assert tp.seg_net.outconv.weight.dtype == torch.bfloat16
    tp.seg_net = build_u2net(sd, "cpu", torch.float32)
    return jp, tp


def _clips(b=3, t=7):
    """B different uint8 clips at model resolution: the blob video from
    different first frames."""
    video = load_video(VIDEO, dtype=np.uint8, resize_to=28)
    return np.stack([video[i:i + t] for i in range(b)])


def _stacked(b=3):
    inputs, _, _ = prepare_mesh_inputs(load_mesh(MESH), 64)
    return {k: np.concatenate([v] * b) for k, v in inputs.items()}


@pytest.mark.parametrize("segment", [False, True], ids=["off", "border"])
def test_predict_batch_matches_jax(pipelines, segment):
    jp, tp = pipelines
    inputs, videos = _stacked(), _clips()
    want = jp.predict_batch(inputs, videos, segment=segment)
    got = tp.predict_batch(inputs, videos, segment=segment)
    assert got.shape == want.shape == (3, 7, 162, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_batched_clips_match_each_clip_alone(pipelines):
    _, tp = pipelines
    inputs, videos = _stacked(), _clips()
    batched = tp.predict_batch(inputs, videos, segment="u2net")
    one = {k: v[:1] for k, v in inputs.items()}
    for i in range(3):
        alone = tp.predict(one, videos[i], segment="u2net")
        np.testing.assert_allclose(batched[i:i + 1], alone, atol=SELF_TOL,
                                   rtol=SELF_TOL)


def test_u2net_mode_matches_jax_in_graph(pipelines):
    """The JAX pipeline's in-graph U2Net (segment="u2net") against the
    port's, and the mask is not trivial: the result differs from both the
    unmasked and the border-masked one."""
    jp, tp = pipelines
    inputs, _, _ = prepare_mesh_inputs(load_mesh(MESH), 64)
    video = _clips(1)[0]
    want = jp.predict(inputs, video, segment="u2net")
    got = tp.predict(inputs, video, segment="u2net")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for other in (False, "border"):
        assert np.abs(got - tp.predict(inputs, video, segment=other)).max() > 1e-3


def test_call_weights_are_used_for_that_call(pipelines, u2net_sd):
    """Weights given to a call replace the constructor's for that call
    only (the JAX pipeline would keep its first set)."""
    _, tp = pipelines
    inputs, _, _ = prepare_mesh_inputs(load_mesh(MESH), 64)
    video = _clips(1)[0]
    own = tp.predict(inputs, video, segment="u2net")
    other = {k: torch.from_numpy(v) for k, v in
             _u2net_torch_sd(np.random.RandomState(4)).items()}
    with_other = tp.predict(inputs, video, segment="u2net", seg_params=other)
    assert np.abs(with_other - own).max() > 1e-3
    assert tp._call_seg[1].outconv.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.predict(inputs, video, segment="u2net"), own)
    with pytest.raises(ValueError, match="U2Net weights"):
        MotionPipeline(ModelConfig(**SMALL), device="cpu").predict(
            inputs, video, segment="u2net")


def _write_jobs(tmp_path, n=3, mp4=False):
    """Clips and a second mesh with another vertex count; returns the (mesh,
    video) jobs: the blob for the first n - 1, the octahedron last. The
    clips are .npy arrays of 7 frames from different first frames, or with
    ``mp4`` copies of blob.mp4 (the JAX package reads no .npy video)."""
    import shutil
    (tmp_path / "octa.obj").write_text(OCTAHEDRON)
    video = load_video(VIDEO, dtype=np.uint8, resize_to=28)
    jobs = []
    for i in range(n):
        path = tmp_path / f"clip{i}.{'mp4' if mp4 else 'npy'}"
        if mp4:
            shutil.copy(VIDEO, path)
        else:
            np.save(path, video[i:i + 7])
        mesh = MESH if i < n - 1 else str(tmp_path / "octa.obj")
        jobs.append((mesh, str(path)))
    return jobs


def test_run_batch_groups_by_shape_and_writes_glbs(pipelines, weights,
                                                   tmp_path):
    """Two blob jobs go through one batch of 2, the octahedron job alone;
    each GLB holds the animation of the JAX run_batch (both on the border
    fallback: neither pipeline holds U2Net weights)."""
    jobs = _write_jobs(tmp_path, mp4=True)
    jp = JaxPipeline(JaxConfig(**SMALL), weights, window=3, decode_chunk=16,
                     u16_readback=False)
    tp = MotionPipeline(ModelConfig(**SMALL), state_dict=params_from_jax(weights),
                        window=3, decode_chunk=16, device="cpu")
    sizes = []
    real = tp._predict_field    # a group's forward, its field on the device

    def spy(inputs, videos, *a):
        sizes.append((len(videos), inputs["ref_pcd"].shape[1]))
        return real(inputs, videos, *a)
    tp._predict_field = spy
    paths = tp.run_batch(jobs, str(tmp_path / "port"), num_shape_samples=64,
                         max_frames=7)
    assert sorted(sizes) == [(1, 6), (2, 162)]
    want = jp.run_batch(jobs, str(tmp_path / "jax"), num_shape_samples=64,
                        max_frames=7)
    for (_, video), path, wpath in zip(jobs, paths, want):
        stem = os.path.splitext(os.path.basename(video))[0]
        assert path == str(tmp_path / "port" / stem / "output_animation.glb")
        _, faces, frames, _ = load_animated_glb(path)
        _, wfaces, wframes, _ = jax_load_animated_glb(wpath)
        assert frames.shape[0] == 7 and np.isfinite(frames).all()
        np.testing.assert_array_equal(faces, wfaces)
        np.testing.assert_allclose(frames, wframes, atol=TOL, rtol=TOL)


def test_decode_chunk_rule_matches_the_jax_script():
    """chunk x B about 32, the largest divisor of the window not above it
    (scripts/batch_inference.py): at a 12-frame window B = 4 takes 6."""
    for window, batch, want in [(12, 1, 12), (12, 4, 6), (12, 8, 4),
                                (12, 3, 6), (256, 1, 32), (256, 4, 8),
                                (7, 4, 7), (12, 64, 1)]:
        assert batch_inference.decode_frames_chunk(window, batch) == want


@pytest.fixture
def tiny_yaml(tmp_path):
    model = "".join(f"  {k}: {v}\n" for k, v in SMALL.items() if k != "frames")
    path = tmp_path / "tiny.yaml"
    path.write_text(f"model:\n{model}  use_qk_norm: true\n  dtype: float32\n"
                    f"training:\n  frames: {SMALL['frames']}\n"
                    f"  num_shape_samples: 64\n")
    return str(path)


@pytest.mark.parametrize("batch", [1, 2])
def test_batch_cli_isolates_failures(tmp_path, tiny_yaml, batch):
    """A malformed line and a job whose video is missing fail alone (at
    batch 2 the missing video fails its group, whose jobs are then retried
    one by one); the good jobs write their GLBs; the exit code is 1. A list
    of good jobs exits 0."""
    jobs = _write_jobs(tmp_path)
    lines = [f"{m} {v}" for m, v in jobs[:2]] + [
        "only_one_field.glb", f"{MESH} {tmp_path / 'missing.npy'}",
        "# a comment", "", f"{jobs[2][0]} {jobs[2][1]}"]
    (tmp_path / "jobs.txt").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    args = ["--list", str(tmp_path / "jobs.txt"), "--output", str(out),
            "--config", tiny_yaml, "--device", "cpu", "--batch", str(batch)]
    assert batch_inference.main(args) == 1
    made = sorted(p.parent.name for p in out.glob("*/output_animation.glb"))
    assert made == ["clip0", "clip1", "clip2"]
    (tmp_path / "good.txt").write_text("\n".join(lines[:2]) + "\n")
    assert batch_inference.main(args[:1] + [str(tmp_path / "good.txt")]
                                + args[2:]) == 0
