"""The port's tooling against the JAX package's, on the CPU: the
environment-gated spans and phase timers (their report, the device sync,
the torch.profiler trace, the span tree of ``MotionPipeline.run``), the three debug
visualisations, ``write_video``, the ``images2video`` CLI and the native
``build_hierarchy``, bit for bit against the JAX package's.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from motion324_tpu.io.video import write_video as jax_write_video
from motion324_tpu.native import build_hierarchy as jax_build_hierarchy
from motion324_tpu.utils import profiling as jax_profiling
from motion324_tpu.utils import visualization as jax_vis
from motion324_tpu_torch import images2video
from motion324_tpu_torch.io.png import encode_png
from motion324_tpu_torch.io.video import read_video, write_video
from motion324_tpu_torch.native import build_hierarchy
from motion324_tpu_torch.utils import profiling, visualization

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples", "synthetic")


def _timer_lines(out: str) -> list[str]:
    return [ln.split(":")[0] for ln in out.splitlines()
            if ln.startswith("[motion324 timer]")]


def test_phase_timer_and_timed_report_as_the_jax_ones(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "_ENABLED", False)
    with profiling.phase_timer("off"):
        pass
    assert capsys.readouterr().out == ""
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod, "_ENABLED", True)
        monkeypatch.setattr(mod, "_TRACE_DIR", None)
    synced = []
    monkeypatch.setattr(profiling, "_sync", lambda tree: synced.append(tree))
    x = torch.ones(3)
    with profiling.phase_timer("stage", sync=[x]):
        with profiling.span("inner"):
            pass
    got = capsys.readouterr().out
    with jax_profiling.phase_timer("stage"):
        pass
    want = capsys.readouterr().out
    assert _timer_lines(got) == _timer_lines(want) == ["[motion324 timer] stage"]
    assert all(ln.endswith(" ms") for ln in got.splitlines())
    assert len(synced) == 1 and synced[0][0] is x


def test_profile_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    """``MOTION324_TRACE_DIR``: one trace a traced root span (its phases and
    the gaps between them), none for a phase alone or inside a profiler
    that is already running."""
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_TRACE_DIR", str(tmp_path / "traced"))
    with profiling.phase_timer("phase alone"):
        torch.ones(8).sum()
    with profiling.span("motion.run", trace=True):
        with profiling.phase_timer("traced phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with profiling.span("motion.run", trace=True):   # not a root
            torch.ones(8).sum()
    with profiling.profile_trace(str(tmp_path / "explicit")):
        torch.ones(8).sum()
        with profiling.span("motion.run", trace=True):
            torch.ones(8).sum()
    for sub in ("traced", "explicit"):
        files = os.listdir(tmp_path / sub)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(tmp_path / sub / files[0]) as f:
            assert json.load(f)["traceEvents"]
    with open(tmp_path / "traced" / os.listdir(tmp_path / "traced")[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"motion.run", "traced phase"} <= names
    assert "phase alone" not in names


def test_spans_off_record_nothing_and_open_no_range(monkeypatch, tmp_path):
    """Unset, a span and a phase timer record nothing and open no profiler
    range; a span asked for its seconds measures them all the same."""
    from torch.profiler import profile
    from motion324_tpu_torch.io.glb import export_animated_glb
    monkeypatch.setattr(profiling, "_ENABLED", False)
    profiling.reset()
    with profile() as prof:
        with profiling.phase_timer("video decode"), profiling.span("inner"):
            torch.ones(8).sum()
        with profiling.span("asked", timed=True) as asked:
            torch.ones(8).sum()
        export_animated_glb(str(tmp_path / "a.glb"), np.zeros((3, 3)),
                            np.array([[0, 1, 2]]), np.ones((2, 3, 3)))
    assert profiling.spans() == []
    names = {e.name for e in prof.events()}
    assert not names & {"video decode", "inner", "asked", "export.glb.texture",
                        "export.glb.targets", "export.glb.write"}
    assert asked.seconds > 0


def test_motion_pipeline_run_times_its_phases(monkeypatch, capsys, tmp_path):
    """``MotionPipeline.run`` under ``MOTION324_DEBUG=1`` times the phases
    the JAX package's run times, once each (the video decode is not
    overlapped with the mesh load here)."""
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    from test_torch_pipeline import SMALL
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_TRACE_DIR", None)
    pipe = MotionPipeline(ModelConfig(**SMALL), window=3, decode_chunk=16,
                          device="cpu")
    pipe.run(os.path.join(ROOT, "blob.glb"), os.path.join(ROOT, "blob.mp4"),
             str(tmp_path), num_shape_samples=64, max_frames=4)
    names = [ln.split("] ")[1] for ln in _timer_lines(capsys.readouterr().out)]
    assert names == ["video decode", "mesh load+sample", "model predict",
                     "smoothing", "glb export"]


def test_motion_pipeline_run_records_its_span_tree(monkeypatch, tmp_path):
    """With spans on, one ``MotionPipeline.run`` is one ``motion.run`` root
    whose children are the five phases; ``model predict`` holds the shape
    encoding and, for each window, the mask, the video encoding and one
    ``predict.decode_points`` a decode chunk; ``smoothing`` holds the one
    copy of the finished field to the host; the video decode and the GLB
    export hold their sub-spans."""
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    from motion324_tpu_torch.inference.windowing import window_starts
    from motion324_tpu_torch.io.mesh import load_mesh
    from test_torch_pipeline import SMALL
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_TRACE_DIR", None)
    pipe = MotionPipeline(ModelConfig(**SMALL), window=3, decode_chunk=16,
                          device="cpu")
    mesh = os.path.join(ROOT, "blob.glb")
    profiling.reset()
    pipe.run(mesh, os.path.join(ROOT, "blob.mp4"), str(tmp_path),
             num_shape_samples=64, max_frames=4)
    recs = sorted(profiling.spans(), key=lambda r: r.start_ns)
    root, = [r for r in recs if r.parent is None]
    assert root.name == "motion.run" and all(r.root == root.id for r in recs)
    by_id = {r.id: r for r in recs}
    assert all(by_id[r.parent].start_ns <= r.start_ns <= r.end_ns
               <= by_id[r.parent].end_ns for r in recs if r is not root)

    def kids(name):
        parent, = [r for r in recs if r.name == name]
        return [r.name for r in recs if r.parent == parent.id]
    assert kids("motion.run") == ["video decode", "mesh load+sample",
                                  "model predict", "smoothing", "glb export"]
    chunks = -(-len(load_mesh(mesh).vertices) // 16)
    window = (["predict.segment", "predict.encode_video"]
              + ["predict.decode_points"] * chunks)
    assert kids("model predict") == ["predict.encode_shape"] + window * len(
        window_starts(4, 3))
    assert kids("smoothing") == ["smoothing.to_host"]
    assert kids("video decode") == ["video.load"]
    assert kids("glb export") == ["export.glb.coords", "export.glb.texture",
                                  "export.glb.targets", "export.glb.write"]
    assert all(r.device_s == r.host_s for r in recs)


def _trajs(seed, t=5, n=300):
    rng = np.random.RandomState(seed)
    base = rng.randn(1, 1, n, 3).astype(np.float32) * 0.3
    return base + np.cumsum(rng.randn(1, t, n, 3) * 0.01, 1).astype(np.float32)


def test_visualizations_match_the_jax_ones(tmp_path):
    """Each figure, drawn from the same inputs by each package, decodes to
    the same pixels."""
    import imageio.v3 as iio
    rng = np.random.RandomState(0)
    inputs = {"ref_shape_pcd": rng.randn(1, 200, 3), "ref_pcd": rng.randn(1, 50, 3),
              "ref_shape_rgbs": rng.rand(1, 200, 3),
              "ref_shape_normals": rng.randn(1, 200, 3)}
    trajs, gt = _trajs(1), _trajs(2)
    smooth = trajs * 0.9
    runs = [
        ("inputs.png", lambda m, p: m.visualize_input_data(inputs, p)),
        ("motion.gif", lambda m, p: m.visualize_point_cloud_motion(
            trajs, p, gt=gt, fps=4, max_points=100)),
        ("smoothing.png", lambda m, p: m.plot_smoothing_comparison(
            trajs, smooth, 0.002, p)),
    ]
    for name, draw in runs:
        got = draw(visualization, str(tmp_path / "port" / name))
        want = draw(jax_vis, str(tmp_path / "jax" / name))
        a, b = iio.imread(got), iio.imread(want)
        assert a.shape == b.shape and a.size > 0, name
        np.testing.assert_array_equal(a, b)


def test_write_video_matches_the_jax_one(tmp_path):
    """Odd sizes are cropped to even ones; float frames are quantised as
    the JAX writer quantises them; both files decode to the same frames."""
    frames = np.random.RandomState(3).rand(4, 33, 47, 3).astype(np.float32)
    got = write_video(str(tmp_path / "a" / "port.mp4"), frames, fps=8)
    want = jax_write_video(str(tmp_path / "b" / "jax.mp4"), frames, fps=8)
    a, b = read_video(got, dtype=np.uint8), read_video(want, dtype=np.uint8)
    assert a.shape == (4, 32, 46, 3)
    np.testing.assert_array_equal(a, b)


def test_images2video_matches_the_jax_script(tmp_path):
    """PNGs (RGB, RGBA and grey, read with the port's codec) and a JPEG in
    natural order (frame_2 before frame_10), against
    scripts/images2video.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_images2video", os.path.join(os.path.dirname(__file__), "..",
                                         "scripts", "images2video.py"))
    jax_i2v = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_i2v)
    rng = np.random.RandomState(4)
    src = tmp_path / "frames"
    src.mkdir()
    for i in (10, 2, 1):
        img = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
        if i == 10:
            img = np.concatenate([img, np.full((24, 32, 1), 200, np.uint8)], -1)
        (src / f"frame_{i}.png").write_bytes(encode_png(img))
    cv2.imwrite(str(src / "frame_3.jpg"), (rng.rand(24, 32, 3) * 255).astype(np.uint8))
    names = sorted(os.listdir(src), key=images2video.natural_key)
    assert names == ["frame_1.png", "frame_2.png", "frame_3.jpg", "frame_10.png"]
    assert images2video.main(["--input", str(src), "--output",
                              str(tmp_path / "port.mp4"), "--fps", "6"]) == 0
    jax_i2v.images_to_video(str(src), str(tmp_path / "jax.mp4"), fps=6)
    a = read_video(str(tmp_path / "port.mp4"), dtype=np.uint8)
    b = read_video(str(tmp_path / "jax.mp4"), dtype=np.uint8)
    assert a.shape == (4, 24, 32, 3)
    np.testing.assert_array_equal(a, b)
    grey = tmp_path / "grey"
    grey.mkdir()
    (grey / "0.png").write_bytes(encode_png(np.full((8, 8, 1), 77, np.uint8)))
    images2video.images_to_video(str(grey), str(tmp_path / "grey.mp4"))
    assert read_video(str(tmp_path / "grey.mp4"), dtype=np.uint8).shape == (1, 8, 8, 3)
    with pytest.raises(FileNotFoundError):
        images2video.images_to_video(str(tmp_path / "grey" / ".."), "x.mp4")


@pytest.mark.parametrize("levels,res,h", [(3, 48, 48), (2, 32, 32), (3, 40, 37)])
def test_build_hierarchy_matches_the_jax_one_bit_for_bit(levels, res, h):
    from test_native import _sphere_views
    vp, vn = _sphere_views(H=h)
    got = build_hierarchy(vp, vn, num_level=levels, resolution=res)
    want = jax_build_hierarchy(vp, vn, num_level=levels, resolution=res)
    assert got.keys() == want.keys()
    assert got["level_sizes"] == want["level_sizes"]
    for key in ("positions", "origin_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("neighbors", "downsample", "even_corners", "odd_corners"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        build_hierarchy(vp[:2], vn[:2])
