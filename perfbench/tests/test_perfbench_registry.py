"""The harness finds configurations, cells and metrics by name, and
BENCHMARK.json agrees with the files it names; a new cell or metric is a
matter of new files."""

import json
import shutil
from pathlib import Path

import pytest

from perfbench.lib import bench

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def test_every_cell_of_benchmark_json_has_its_files():
    names = {p.stem for p in (ROOT / "workloads").glob("*.json")}
    assert names == set(bench.workload_names())
    for w in BENCHMARK["workloads"]:
        spec = bench.load_json("workloads", w["name"])
        assert (ROOT / "drivers" / f"{spec['driver']}.py").exists()
        assert bench.end_to_end_of(w["name"]) != "setup_s"
        assert bench.metrics_for(w["name"]), w["name"]


def test_every_config_of_benchmark_json_is_its_file():
    for c in BENCHMARK["configs"]:
        path = ROOT.parent / c["file"]
        assert path.parent == ROOT / "configs" and path.stem == c["name"]
        data = json.loads(path.read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_every_per_layer_metric_is_its_reader():
    names = {p.stem for p in (ROOT / "metrics").glob("*.py")}
    assert names == {m["name"] for m in BENCHMARK["per_layer"]}
    for m in BENCHMARK["per_layer"]:
        assert callable(bench.load_module("metrics", m["name"]).read)
        for cell in m["workloads"]:
            assert bench.end_to_end_of(cell) == m["moves"]
            assert m["name"] in bench.metrics_for(cell)


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A new cell and a new metric: new files under perfbench/ and their
    entries in BENCHMARK.json, no file edited."""
    copy = tmp_path / "perfbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = bench.load_json("workloads", "shape-latents50")
    spec["traffic_params"]["images"] = 2
    (copy / "workloads" / "shape-latents2img.json").write_text(json.dumps(spec))
    (copy / "metrics" / "requests.extra.py").write_text(
        "def read(ctx):\n    return ctx['requests']\n")
    entries = json.loads(json.dumps(BENCHMARK))
    entries["workloads"].append({"name": "shape-latents2img", "config": "hunyuan3d2-shape",
                                 "traffic": "image518-2img", "chips": 1, "why": "test"})
    entries["end_to_end"][1]["workloads"].append("shape-latents2img")
    assert entries["end_to_end"][1]["name"] == "shape_latents_s"
    entries["per_layer"].append({"name": "requests.extra", "unit": "1", "better": "higher",
                                 "source": "host_clock", "layer": "whole request",
                                 "moves": "shape_latents_s",
                                 "workloads": ["shape-latents2img"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(entries))
    assert "shape-latents2img" in bench.workload_names(copy)
    assert set(bench.metrics_for("shape-latents2img", copy)) == {"requests.extra"}
    r = bench.run_cell("shape-latents2img", 7, 0.0, True, 0.0, device="cpu",
                       config_override=TINY_SHAPE, root=copy)
    assert r["metrics"]["requests.extra"]["value"] == 1.0
    assert r["correct"] is True


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "motion324_tpu_torchx", types.ModuleType("x"))
    assert "motion324_tpu_torchx" not in bench.forbidden_modules()
    for name in ("jax.numpy", "motion324_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in bench.forbidden_modules()


def test_stream_seeds_take_any_whole_seed():
    big = 2 ** 31 + 12345
    assert bench.stream_seed(big, 1) != bench.stream_seed(big, 2)
    assert 0 <= bench.stream_seed(-big, 3) < 2 ** 63


TINY_SHAPE = dict(image_size=28, cond_dim=48, cond_depth=1, cond_heads=3,
                  cond_native_grid=2, dit_hidden=48, dit_heads=3, dit_depth=1,
                  dit_single=1, latent_dim=8, num_latents=16, vae_width=48,
                  vae_heads=3, vae_layers=1, steps=3, dtype="float32")


@pytest.mark.parametrize("name", ["motion-clip256", "shape-latents50"])
def test_run_refuses_without_enough_cuda_devices(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        bench.run_cell(name, 1, 1.0, False, 0.0)
