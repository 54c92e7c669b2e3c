"""The port stands alone: it imports neither JAX, flax nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from motion324_tpu_torch import resolve_device
from motion324_tpu_torch import cli
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.pipeline import MotionPipeline

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "motion324_tpu_torch"
TINY = ModelConfig(feat_dim=36, tokens=4, pcd_layers=1, n_alternating_layers=2,
                   head_dim=12, frames=3, image_size=28, patch_size=14,
                   dino_depth=1, dino_heads=3)

# an import of the JAX package: `motion324_tpu` followed by a word boundary
# that is not the `_torch` of the port's own name
_JAX_PKG = re.compile(r"^\s*(from|import)\s+motion324_tpu(?!_torch)\b", re.M)
_JAX = re.compile(r"^\s*(from|import)\s+(jax|flax|jaxlib)\b", re.M)


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, sys, motion324_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'jaxlib', 'motion324_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


TRAINING_MODULES = [
    "motion324_tpu_torch.training.loss", "motion324_tpu_torch.training.optimizer",
    "motion324_tpu_torch.training.train_step",
    "motion324_tpu_torch.training.checkpoints",
    "motion324_tpu_torch.training.trainer", "motion324_tpu_torch.data.tracking",
    "motion324_tpu_torch.data.dyscene", "motion324_tpu_torch.utils.logging",
    "motion324_tpu_torch.train"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_load_neither_jax_nor_pil_nor_yaml(module):
    """Each training module alone: no JAX, and PIL and PyYAML, which the
    card's machine lacks, stay unloaded until a function needs them."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'motion324_tpu', 'PIL', 'yaml'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("pattern", [_JAX_PKG, _JAX], ids=["jax_package", "jax"])
def test_sources_import_neither_jax_nor_the_jax_package(pattern):
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in _sources() for m in pattern.finditer(f.read_text())]
    assert hits == []


def test_pattern_tells_the_two_packages_apart():
    assert _JAX_PKG.search("from motion324_tpu.ops import x")
    assert _JAX_PKG.search("import motion324_tpu")
    assert not _JAX_PKG.search("from motion324_tpu_torch.ops import x")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_pipeline_raises_without_cuda_unless_asked_for_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        MotionPipeline(TINY)
    pipe = MotionPipeline(TINY, device="cpu")
    assert next(pipe.model.parameters()).device.type == "cpu"


def test_cli_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mesh", "m.glb", "--video", "v.npy",
                  "--output", str(tmp_path)])


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
