"""The port's host training loop, checkpoints and dataset, on the CPU.

The trainer runs a few steps of a tiny model with gradient accumulation;
checkpoints are named by applied updates and resumed; the Dyscene16k
dataset copy draws the same samples as the JAX package's from the same seed
on a tiny on-disk set built by examples/make_synthetic_dyscene.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from motion324_tpu.config import load_config
from motion324_tpu.data.dyscene import DysceneDataset as JaxDataset
from motion324_tpu_torch import train as train_cli
from motion324_tpu_torch.config import ModelConfig, load_train_config
from motion324_tpu_torch.data.dyscene import DysceneDataset, collate
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.training.checkpoints import (auto_resume,
                                                      find_checkpoints,
                                                      restore_params,
                                                      save_checkpoint)
from motion324_tpu_torch.training.train_step import create_train_state
from motion324_tpu_torch.training.trainer import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAML = os.path.join(ROOT, "configs", "dyscene.yaml")
TINY = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
            head_dim=12, frames=2, image_size=28, patch_size=14, drop_rate=0.1,
            dino_depth=1, dino_heads=3)


def _cfg(tmp_path, *extra):
    return load_train_config(YAML, [
        "training.grad_accum_steps=2", "training.batch_size_per_device=1",
        "training.train_steps=3", "training.stop_steps=3", "training.warmup=1",
        "training.allowed_gradnorm_factor=1e9", "training.remat=true",
        f"training.checkpoint_dir={tmp_path}/ckpt", "training.checkpoint_every=2",
        "training.log_every=1", "training.print_every=100", *extra])


def _batches():
    r = np.random.RandomState(0)
    while True:
        b = 2   # accumulation 2 x micro-batch 1
        yield {
            "ref_shape_pcd": r.randn(b, 32, 3).astype(np.float32) * 0.3,
            "ref_shape_normals": r.randn(b, 32, 3).astype(np.float32),
            "ref_shape_rgbs": r.rand(b, 32, 3).astype(np.float32),
            "ref_pcd": r.randn(b, 16, 3).astype(np.float32) * 0.3,
            "ref_normal": r.randn(b, 16, 3).astype(np.float32),
            "ref_rgb": r.rand(b, 16, 3).astype(np.float32),
            "rgb_video": r.rand(b, 2, 28, 28, 3).astype(np.float32),
            "point_clouds": r.randn(b, 2, 16, 3).astype(np.float32) * 0.3,
            "obj_name": ["synthetic"] * b,   # a metadata entry, dropped
        }


def test_trainer_loop_checkpoints_and_resumes(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, ModelConfig(**TINY), _batches(), device="cpu")
    state = trainer.train()
    assert (state.step, state.update_step) == (3, 3)
    # saved at step 2 (checkpoint_every) and at the last step, by updates
    names = [os.path.basename(p) for p in find_checkpoints(cfg.checkpoint_dir)]
    assert names == ["ckpt_0000000000000002", "ckpt_0000000000000003"]
    lines = open(os.path.join(cfg.checkpoint_dir, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 3 and '"grad_norm"' in lines[0]

    # a fresh trainer resumes at step 3 and has nothing left to do
    again = Trainer(cfg, ModelConfig(**TINY), _batches(), device="cpu")
    state2 = again.train()
    assert (state2.step, state2.update_step) == (3, 3)
    for (n, a), b in zip(state.model.state_dict().items(),
                         state2.model.state_dict().values()):
        assert torch.equal(a, b), n
    # and trains on to a later stop
    state3 = Trainer(cfg, ModelConfig(**TINY), _batches(), device="cpu").train(
        max_steps=4)
    assert (state3.step, state3.update_step) == (4, 4)


def test_auto_resume_restores_the_latest_and_reset_keeps_only_params(tmp_path):
    cfg = _cfg(tmp_path)
    state = create_train_state(MotionLatentModel(ModelConfig(**TINY), seed=0), cfg)
    for step, upd in ((5, 4), (9, 7)):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step, state.update_step = step, upd
        path = save_checkpoint(cfg.checkpoint_dir, state)
        assert os.path.basename(path) == f"ckpt_{upd:016d}"
    latest = {k: v.clone() for k, v in state.model.state_dict().items()}

    fresh = create_train_state(MotionLatentModel(ModelConfig(**TINY), seed=1), cfg)
    fresh, found = auto_resume(cfg.checkpoint_dir, fresh)
    assert found.endswith("ckpt_0000000000000007")
    assert (fresh.step, fresh.update_step) == (9, 7)
    assert all(torch.equal(v, latest[k]) for k, v in fresh.model.state_dict().items())

    reset = create_train_state(MotionLatentModel(ModelConfig(**TINY), seed=1), cfg)
    reset, _ = auto_resume(cfg.checkpoint_dir, reset, reset_training_state=True)
    assert (reset.step, reset.update_step) == (0, 0)
    assert not reset.optimizer.state
    assert all(torch.equal(v, latest[k]) for k, v in reset.model.state_dict().items())

    # params-only restore for inference, into a bf16 model
    model = MotionLatentModel(ModelConfig(**TINY), seed=2).to(torch.bfloat16)
    restore_params(found, model)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, latest[k].to(torch.bfloat16)), k

    empty = create_train_state(MotionLatentModel(ModelConfig(**TINY), seed=1), cfg)
    assert auto_resume(str(tmp_path / "none"), empty)[1] is None


@pytest.fixture(scope="module")
def dyscene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dyscene")
    subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                 "make_synthetic_dyscene.py"),
                    str(root)], check=True, capture_output=True)
    return str(root)


def test_dataset_matches_jax(dyscene_root):
    over = [f"training.dataset_path={dyscene_root}", "training.dataset_begin=0",
            "training.num_shape_samples=64", "training.num_pcd_samples=32",
            "training.frames=4"]
    port = DysceneDataset(load_train_config(YAML, over), seed=3)
    ref = JaxDataset(load_config(YAML, over), seed=3)
    assert port.obj_names == ref.obj_names and len(port) == len(ref) == 4
    for i in (0, 2, 1):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k]
    batch = collate([port[0], port[1]])
    assert batch["rgb_video"].shape == (2, 4, 28, 28, 3)


def test_train_cli_runs_on_the_cpu_and_needs_cuda_otherwise(dyscene_root,
                                                            tmp_path, monkeypatch):
    args = ["--config", YAML, f"training.dataset_path={dyscene_root}",
            "training.dataset_begin=0", "training.frames=2",
            "training.num_shape_samples=32", "training.num_pcd_samples=16",
            "training.batch_size_per_device=1", "training.grad_accum_steps=2",
            "training.train_steps=2", "training.stop_steps=2",
            "training.num_workers=2", f"training.checkpoint_dir={tmp_path}/ck",
            "model.feat_dim=48", "model.tokens=4", "model.pcd_layers=1",
            "model.n_alternating_layers=2", "model.head_dim=12",
            "model.dino_depth=1", "model.dino_heads=3", "model.image_size=28",
            "model.dtype=float32"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(args)
    assert train_cli.main(args + ["--device", "cpu"]) == 0
    assert [os.path.basename(p) for p in find_checkpoints(f"{tmp_path}/ck")]
