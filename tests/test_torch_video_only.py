"""The port's video-only product path (``preprocess_video`` and
``video_only``) against the JAX package's scripts, on the CPU at tiny
widths: the preprocessing CLI writes the crops and masks of
``scripts/preprocess_video.py``; each stage of
``scripts/inference_with_video_only.py``, handed the JAX stage's output,
gives that stage's result (shape through ``shape_params_from_jax``, the
cleanup, motion through ``params_from_jax`` within 1e-4 x max|traj| after
smoothing, and the FBX byte for byte); ``video_only.main`` runs end to end
on the CPU when asked and raises without a card otherwise."""

import io
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from motion324_tpu.hy3dgen import postprocess as jax_post
from motion324_tpu.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu.hy3dgen.shape_pipeline import ShapeGenPipeline as JaxShape
from motion324_tpu.inference import pipeline as jax_pipeline
from motion324_tpu.inference.preprocess import (
    preprocess_video_frames as jax_preprocess)
from motion324_tpu.inference.smoothing import (
    smooth_trajectories as jax_smooth)
from motion324_tpu.io.fbx import export_animated_fbx as jax_export_fbx
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu_torch import preprocess_video, video_only
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline
from motion324_tpu_torch.inference.pipeline import MotionPipeline, load_video
from motion324_tpu_torch.inference.preprocess import preprocess_video_frames
from motion324_tpu_torch.io.fbx import load_fbx
from motion324_tpu_torch.io.glb import load_animated_glb, load_glb
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.io.png import decode_png
from motion324_tpu_torch.utils.convert import (params_from_jax,
                                               shape_params_from_jax)
from test_torch_shapegen import DIMS, _redraw_layer_scale, close

ROOT = Path(__file__).resolve().parent.parent
VIDEO = str(ROOT / "examples" / "synthetic" / "blob.mp4")
# the motion model as tests/test_torch_pipeline.py runs it
SMALL = dict(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
             head_dim=12, frames=3, image_size=28, patch_size=14,
             drop_rate=0.0, dino_depth=1, dino_heads=3)
# f32 on both sides: the same function with sums in another order
TRAJ_TOL = 1e-4


@pytest.fixture
def jax_scripts():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import preprocess_video as jax_cli
        yield jax_cli
    finally:
        sys.path.remove(str(ROOT / "scripts"))


def _pngs(directory: Path) -> list:
    names = sorted(os.listdir(directory))
    assert names == [f"frame_{t:04d}.png" for t in range(len(names))]
    return [(directory / n).read_bytes() for n in names]


@pytest.mark.parametrize("flags", [[], ["--model", "u2net"], ["--split-only"]],
                         ids=["heuristic", "u2net_without_weights",
                              "split_only"])
def test_preprocess_cli_writes_the_jax_clis_pngs(tmp_path, jax_scripts, flags):
    """The same PNG pixels (decoded by PIL, and the port's by decode_png
    too) in masked_rgb/ and masks/ (frames/ with --split-only); --model
    without --weights falls back to the border heuristic on both sides."""
    args = ["--input", VIDEO, "--max-frames", "4", "--size", "64", *flags]
    assert preprocess_video.main([*args, "--output", str(tmp_path / "port"),
                                  "--device", "cpu"]) == 0
    assert jax_scripts.main([*args, "--output", str(tmp_path / "jax")]) == 0
    dirs = ["frames"] if flags == ["--split-only"] else ["masked_rgb", "masks"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(dirs)
    for d in dirs:
        got, want = _pngs(tmp_path / "port" / d), _pngs(tmp_path / "jax" / d)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            pil = lambda b: np.asarray(Image.open(io.BytesIO(b)))
            np.testing.assert_array_equal(pil(g), pil(w))
            np.testing.assert_array_equal(decode_png(g).reshape(pil(w).shape),
                                          pil(w))


def test_preprocess_stage_matches_jax():
    """Crops, masks and the bounding box of the 512^2 stage the video-only
    path runs (border heuristic)."""
    raw = load_video(VIDEO, 4)
    got = preprocess_video_frames(raw, size=512)
    want = jax_preprocess(jax_pipeline.load_video(VIDEO, 4), size=512)
    assert tuple(int(v) for v in got[2]) == tuple(int(v) for v in want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def crops():
    """The JAX stage-1 output: 512^2 crops of blob.mp4's first 5 frames."""
    frames, _, _ = jax_preprocess(jax_pipeline.load_video(VIDEO, 5), size=512)
    return frames


@pytest.fixture(scope="module")
def shape_pair():
    jp = JaxShape.init_random(jax.random.PRNGKey(3), dtype=jnp.float32, **DIMS)
    jp.params = _redraw_layer_scale(jp.params, 4)
    tp = ShapeGenPipeline(shape_params_from_jax(jp.params), device="cpu",
                          dtype=torch.float32, **DIMS)
    return jp, tp


def test_shape_stage_matches_jax_on_the_jax_crop(shape_pair, crops):
    """Frame 0 of the JAX crops through the shape stage, each sub-stage fed
    the JAX one's output: the resize to the conditioner's input (both
    antialiased linear), the condition tokens, the Euler loop from the
    same noise, the ShapeVAE decode and the occupancy query."""
    jp, tp = shape_pair
    s = DIMS["image_size"]
    want_img = np.asarray(jax.image.resize(jnp.asarray(crops[0]), (s, s, 3),
                                           method="linear", antialias=True))
    close(tp.prepare_image(crops[0])[0], want_img, rel=1e-4)
    want = jp._encode_cond(jp.params["conditioner"], want_img[None])
    close(tp.encode_cond(want_img[None]), want)
    cond_pair = np.concatenate([np.asarray(want), np.zeros_like(want)])
    lat = np.random.default_rng(7).standard_normal(
        (1, DIMS["num_latents"], DIMS["latent_dim"])).astype(np.float32)
    sig = flow_match_sigmas(3)
    want_lat = jp._denoise(jp.params["dit"], lat, cond_pair, sig, 5.0)
    close(tp.denoise(lat, cond_pair, sig, 5.0), want_lat)
    want_proc = jp._vae_decode(jp.params["vae"], np.asarray(want_lat))
    close(tp.vae_decode(np.asarray(want_lat)), want_proc)
    pts = np.random.default_rng(8).uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    close(tp.vae_query(pts, torch.from_numpy(np.asarray(want_proc))),
          jp._vae_query(jp.params["vae"], pts, want_proc))


@pytest.fixture(scope="module")
def jax_mesh(shape_pair, crops):
    """The JAX shape stage's mesh from frame 0 and the JAX script's cleanup
    of it (at 300 faces): (raw, cleaned)."""
    jp, _ = shape_pair
    raw = jp(crops[0], num_inference_steps=2, octree_resolution=32,
             recenter=False)
    mesh = jax_post.reduce_faces(jax_post.remove_degenerate(
        jax_post.remove_floaters(raw)), 300)
    assert len(mesh.faces) > 0
    return raw, mesh


def test_cleanup_stage_matches_jax(jax_mesh):
    raw, want = jax_mesh
    got = video_only.clean_mesh(TriMesh(vertices=raw.vertices,
                                        faces=raw.faces), 300)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


@pytest.fixture(scope="module")
def motion_pair():
    verts = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    sample = {"ref_shape_pcd": verts[None], "ref_shape_normals": verts[None],
              "ref_shape_rgbs": verts[None], "ref_pcd": verts[None],
              "ref_normal": verts[None], "ref_rgb": verts[None],
              "rgb_video": np.zeros((1, 3, 28, 28, 3), np.float32)}
    params = JaxModel(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0), sample)
    r = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(params))
    jp = jax_pipeline.MotionPipeline(JaxConfig(**SMALL), params, window=3,
                                     u16_readback=False)
    tp = MotionPipeline(ModelConfig(**SMALL), state_dict=params_from_jax(params),
                        window=3, device="cpu")
    return jp, tp


def test_motion_and_fbx_stages_match_jax(tmp_path, motion_pair, jax_mesh,
                                         crops):
    """The JAX cleaned mesh and crops through the motion stage: the smoothed
    trajectories within 1e-4 x max|traj|; the animation written from the
    JAX trajectories is the JAX script's FBX byte for byte."""
    jp, tp = motion_pair
    _, mesh = jax_mesh
    inputs, _, norm = jax_pipeline.prepare_mesh_inputs(mesh, 256)
    want = jax_smooth(jp.predict(inputs, crops), method="combined",
                      motion_threshold=0.002, sigma=1.0)[0]
    got, norm_mesh = video_only.predict_motion(
        tp, TriMesh(vertices=mesh.vertices, faces=mesh.faces), crops, 256)
    assert got.shape == want.shape == (len(crops), len(mesh.vertices), 3)
    np.testing.assert_array_equal(norm_mesh.vertices, norm.vertices)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TRAJ_TOL * scale

    seconds = {}
    glb, fbx = video_only.export_animation(str(tmp_path), norm_mesh, want,
                                           seconds)
    ref = str(tmp_path / "jax.fbx")
    to_b = jax_pipeline.to_blender_coords
    jax_export_fbx(ref, to_b(norm.vertices), norm.faces, to_b(want), uv=norm.uv)
    assert Path(fbx).read_bytes() == Path(ref).read_bytes()
    assert set(seconds) == {"glb", "fbx"}
    _, faces, frames, _ = load_animated_glb(glb)
    np.testing.assert_allclose(frames, to_b(want), atol=1e-6)
    np.testing.assert_array_equal(faces, mesh.faces)


TINY_YAML = ("model:\n" + "".join(f"  {k}: {v}\n" for k, v in SMALL.items()
                                  if k != "frames")
             + "  use_qk_norm: true\n  dtype: float32\n"
             f"training:\n  frames: {SMALL['frames']}\n"
             "  num_shape_samples: 256\n")


def test_main_runs_end_to_end_on_the_cpu(tmp_path):
    """--shape-tiny --texture on a seeded .npy clip, the motion model from a
    tiny YAML config and a painter at small render and atlas sizes: the
    three files, read back with the port's loaders."""
    size, t = 96, 5
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:size, :size]
    clip = 20 + rng.randint(0, 4, (t, size, size, 3))
    for i in range(t):
        disc = (yy - 48 - 8 * np.sin(i)) ** 2 + (xx - 48 - 8 * np.cos(i)) ** 2
        clip[i][disc < 400] = [200, 120, 60]
    np.save(tmp_path / "clip.npy", clip.astype(np.uint8))
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    out = tmp_path / "out"
    rc = video_only.main(
        ["--video", str(tmp_path / "clip.npy"), "--output", str(out),
         "--device", "cpu", "--shape-tiny", "--texture", "--steps", "2",
         "--octree-resolution", "32", "--max-faces", "500", "--no-recenter",
         "--config", str(tmp_path / "tiny.yaml")],
        painter=PaintPipeline(resolution=64, texture_size=128, device="cpu"))
    assert rc == 0
    run = video_only.last_run
    assert set(run["seconds"]) == {"preprocess", "shape", "cleanup", "paint",
                                   "motion", "glb", "fbx"}
    assert 0 < run["faces"] <= 500 and run["frames"] == t
    gen = load_glb(str(out / "generated_mesh.glb"))
    assert gen["texture"].shape == (128, 128, 3) and len(gen["faces"]) == run["faces"]
    base, faces, frames, _ = load_animated_glb(str(out / "output_animation.glb"))
    assert frames.shape == (t, run["vertices"], 3) and np.isfinite(frames).all()
    anim = load_glb(str(out / "output_animation.glb"))
    np.testing.assert_array_equal(anim["texture"], gen["texture"])
    doc = load_fbx(str(out / "output_animation.fbx"))
    np.testing.assert_allclose(doc["vertices"], base, atol=1e-6)
    np.testing.assert_array_equal(doc["faces"], faces)
    assert len(doc["shapes"]) == t


def test_main_stops_on_an_empty_mesh(tmp_path):
    np.save(tmp_path / "clip.npy", np.zeros((2, 32, 32, 3), np.uint8))
    empty = lambda image, **kw: TriMesh(vertices=np.zeros((0, 3), np.float32),
                                        faces=np.zeros((0, 3), np.int64))
    rc = video_only.main(["--video", str(tmp_path / "clip.npy"), "--output",
                          str(tmp_path / "out"), "--device", "cpu"],
                         pipeline=empty, motion=object())
    assert rc == 1 and os.listdir(tmp_path / "out") == []


def test_main_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "clip.npy", np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        video_only.main(["--video", str(tmp_path / "clip.npy"), "--output",
                         str(tmp_path / "out"), "--shape-tiny"])
