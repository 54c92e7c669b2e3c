"""The port stands alone: it imports neither JAX, flax nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU.

Each import check runs in a fresh interpreter forked from a server that
holds only torch and numpy (tests/isolation_probe.py), so that a case pays
for its own module's imports and not for a whole interpreter's start."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
import isolation_probe
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


JAX_NAMES = ("jax", "flax", "jaxlib", "motion324_tpu")


def _check(modules, forbidden, checks=()):
    """Import ``modules`` in a fresh interpreter (forked from a server that
    holds only torch and numpy): nothing of ``forbidden`` loaded, nothing of
    ``checks`` built or started, and nothing of the port loaded before."""
    res = isolation_probe.probe(modules, forbidden, checks)
    assert "error" not in res, res["error"]
    assert res["early"] == [], res["early"]
    assert res["bad"] == [] and res["built"] == [], res


def _port_modules() -> list[str]:
    import pkgutil

    import motion324_tpu_torch as p
    return [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]


def test_importing_every_module_loads_no_jax():
    _check(_port_modules() + ["chip_smoke"], JAX_NAMES)


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
    _check([module], JAX_NAMES + ("PIL", "yaml"))


SHAPE_MODULES = [
    "motion324_tpu_torch.hy3dgen.conditioner", "motion324_tpu_torch.hy3dgen.dit",
    "motion324_tpu_torch.hy3dgen.vae", "motion324_tpu_torch.hy3dgen.volume",
    "motion324_tpu_torch.hy3dgen.scheduler",
    "motion324_tpu_torch.hy3dgen.preprocess_image",
    "motion324_tpu_torch.hy3dgen.postprocess",
    "motion324_tpu_torch.hy3dgen.shape_pipeline", "motion324_tpu_torch.native",
    "motion324_tpu_torch.generate_assets"]


@pytest.mark.parametrize("module", SHAPE_MODULES)
def test_shape_modules_load_neither_jax_nor_cv2_nor_pil(module):
    """Each shape-generation module alone: no JAX, and cv2 and PIL, which
    the card's machine lacks, stay unloaded until a function needs them;
    importing builds nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2"), ("native",))


TEXTURE_MODULES = [
    "motion324_tpu_torch.hy3dgen.camera", "motion324_tpu_torch.hy3dgen.mesh_render",
    "motion324_tpu_torch.hy3dgen.uv_unwrap", "motion324_tpu_torch.hy3dgen.delight",
    "motion324_tpu_torch.hy3dgen.voxel_attention",
    "motion324_tpu_torch.hy3dgen.sd_vae", "motion324_tpu_torch.hy3dgen.sd_unet",
    "motion324_tpu_torch.hy3dgen.paint_diffusion",
    "motion324_tpu_torch.hy3dgen.paint_pipeline",
    "motion324_tpu_torch.ops.rasterizer", "motion324_tpu_torch.ops.masked_attention",
    "motion324_tpu_torch.utils.image", "motion324_tpu_torch.utils.sd_convert"]


@pytest.mark.parametrize("module", TEXTURE_MODULES)
def test_texture_modules_load_neither_jax_nor_cv2_nor_pil(module):
    """Each texture-generation module alone: no JAX, and neither cv2 nor
    PIL (the card's machine has neither: the port's image ops and hole
    fill replace cv2); importing builds nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2"), ("native", "kernels"))


LEGACY_BATCH_MODULES = [
    "motion324_tpu_torch.ops.short_attention", "motion324_tpu_torch.ops.attention",
    "motion324_tpu_torch.inference.segmentation",
    "motion324_tpu_torch.inference.preprocess",
    "motion324_tpu_torch.inference.pipeline",
    "motion324_tpu_torch.batch_inference", "motion324_tpu_torch.cli"]


@pytest.mark.parametrize("module", LEGACY_BATCH_MODULES)
def test_legacy_and_batch_modules_load_no_jax_cv2_pil_yaml(module):
    """Each module of the legacy-route, segmentation and batch slice alone:
    no JAX, and cv2, PIL and PyYAML, which the card's machine lacks, stay
    unloaded until a function needs them; importing builds nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2", "yaml"), ("kernels",))


VIDEO_ONLY_MODULES = [
    "motion324_tpu_torch.io", "motion324_tpu_torch.io.png",
    "motion324_tpu_torch.io.glb", "motion324_tpu_torch.io.fbx",
    "motion324_tpu_torch.io.abc", "motion324_tpu_torch.io.mesh",
    "motion324_tpu_torch.convert", "motion324_tpu_torch.preprocess_video",
    "motion324_tpu_torch.video_only"]


@pytest.mark.parametrize("module", VIDEO_ONLY_MODULES)
def test_export_and_video_only_modules_load_no_jax_pil_cv2_yaml(module):
    """Each module of the video-only path and its exporters alone: no JAX,
    and PIL, cv2 and PyYAML, which the card's machine lacks, stay unloaded
    (the GLB's texture is a PNG of the port's own codec); importing builds
    nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2", "yaml"), ("native", "kernels"))


PARALLEL_MODULES = [
    "motion324_tpu_torch.parallel", "motion324_tpu_torch.parallel.distributed",
    "motion324_tpu_torch.parallel.mesh",
    "motion324_tpu_torch.parallel.collectives",
    "motion324_tpu_torch.parallel.tp", "motion324_tpu_torch.parallel.pp"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_load_no_jax_pil_cv2_yaml(module):
    """Each module of the distributed layer alone: no JAX, and PIL, cv2
    and PyYAML, which the card's machine lacks, stay unloaded; importing
    builds nothing and starts no process group."""
    _check([module], JAX_NAMES + ("PIL", "cv2", "yaml"),
           ("kernels", "process_group"))


EVALUATION_MODULES = [
    "motion324_tpu_torch.evaluation", "motion324_tpu_torch.evaluation.geometry",
    "motion324_tpu_torch.evaluation.video_metrics",
    "motion324_tpu_torch.evaluation.i3d", "motion324_tpu_torch.evaluation.clip_sim",
    "motion324_tpu_torch.evaluation.render_video", "motion324_tpu_torch.evaluate",
    "motion324_tpu_torch.golden_eval"]


@pytest.mark.parametrize("module", EVALUATION_MODULES)
def test_evaluation_modules_load_no_jax_pil_cv2_yaml(module):
    """Each module of the evaluation stack alone: no JAX, and PIL, cv2 and
    PyYAML, which the card's machine lacks, stay unloaded (the protocol's
    resize is the port's INTER_AREA); importing builds nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2", "yaml"), ("native", "kernels"))


EXTRAS_MODULES = [
    "motion324_tpu_torch.hy3dgen.img2img", "motion324_tpu_torch.hy3dgen.delight",
    "motion324_tpu_torch.hy3dgen.super_resolution",
    "motion324_tpu_torch.hy3dgen.text2image",
    "motion324_tpu_torch.hy3dgen.hunyuan_dit_image",
    "motion324_tpu_torch.hy3dgen.diffusion_common",
    "motion324_tpu_torch.utils.convert", "motion324_tpu_torch.utils.sd_convert",
    "motion324_tpu_torch.utils.profiling",
    "motion324_tpu_torch.utils.visualization", "motion324_tpu_torch.io.video",
    "motion324_tpu_torch.images2video", "motion324_tpu_torch.native"]


@pytest.mark.parametrize("module", EXTRAS_MODULES)
def test_extras_and_tooling_modules_load_no_jax_pil_cv2_plots(module):
    """Each module of the texture extras and the tooling alone: no JAX, and
    PIL, cv2, matplotlib and imageio, which the card's machine lacks, stay
    unloaded until a function needs them; importing builds nothing."""
    _check([module], JAX_NAMES + ("PIL", "cv2", "matplotlib", "imageio"),
           ("native", "kernels"))


def test_a_probe_sees_what_a_module_loads():
    """The probe itself: a child starts without the port, and reports what
    an import loads."""
    res = isolation_probe.probe(["motion324_tpu_torch.config", "yaml"],
                                ("yaml", "motion324_tpu_torch"))
    assert res["early"] == [] and "yaml" in res["bad"]
    assert "motion324_tpu_torch.config" in res["bad"]


def test_batch_cli_raises_without_cuda(no_cuda, tmp_path):
    from motion324_tpu_torch import batch_inference
    (tmp_path / "jobs.txt").write_text("m.glb v.npy\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_inference.main(["--list", str(tmp_path / "jobs.txt"),
                              "--output", str(tmp_path)])


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
