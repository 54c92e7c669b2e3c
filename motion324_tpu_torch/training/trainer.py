"""The host training loop (counterpart of
``motion324_tpu/training/trainer.py``): mesh, model, optimizer,
auto-resume, then per step {next batch -> train step -> log -> periodic
checkpoint}. On CUDA the next batch is copied to the card on a side stream
while the current step runs.

On a ``(dp, mp)`` mesh (one process per card under torchrun) each rank's
iterator yields that rank's share of the global batch; under tensor
parallelism (``parallel_mode=gspmd``) the model is built sharded from the
whole seeded state, under pipeline parallelism (``pp``) each ``mp`` rank
holds its stage's pairs of it (``training.pp_microbatches`` microbatches),
and the ranks of one replica train on the batch of its ``mp`` rank 0,
broadcast to the others (a loader's worker threads draw in no fixed
order, so equal seeds do not give equal batches). Rank 0 alone writes the
metrics file and the (whole) checkpoints.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.config import ModelConfig, TrainConfig
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.parallel.collectives import broadcast_first
from motion324_tpu_torch.parallel.mesh import Mesh, make_mesh
from motion324_tpu_torch.training.checkpoints import (auto_resume,
                                                      save_checkpoint)
from motion324_tpu_torch.training.optimizer import lr_at
from motion324_tpu_torch.training.train_step import (TrainState,
                                                     create_train_state,
                                                     train_step)
from motion324_tpu_torch.utils.logging import MetricsLogger, log

__all__ = ["Trainer"]


class Trainer:
    """Drives training from a config and an iterator of host batches.

    Each batch is a dict of numpy arrays with leading axis
    ``grad_accum_steps * batch_size_per_device`` (other entries, such as
    the dataset's ``obj_name`` strings, are dropped): on a mesh, this
    rank's share. The model computes in ``model_cfg.dtype`` with f32
    parameters; ``device`` defaults to CUDA. ``mesh`` defaults to
    ``make_mesh(mesh.dp, mesh.mp)`` of the config over the process group.
    """

    def __init__(self, cfg: TrainConfig, model_cfg: ModelConfig, data_iter,
                 model: MotionLatentModel | None = None, device=None,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_iter = data_iter
        self.mesh = mesh or make_mesh(cfg.mesh_dp, cfg.mesh_mp)
        if model is None:
            split = self.mesh.mp if self.mesh.mp.size > 1 else None
            if cfg.parallel_mode == "pp":
                model = MotionLatentModel(model_cfg, seed=cfg.seed, pp=split,
                                          pp_microbatches=cfg.pp_microbatches)
            else:
                model = MotionLatentModel(model_cfg, seed=cfg.seed, tp=split)
        self.state: TrainState = create_train_state(model.to(self.device), cfg,
                                                    self.mesh)
        self.writer = self.mesh.dp.rank == 0 and self.mesh.mp.rank == 0
        n = sum(p.numel() for p in model.parameters())
        log(f"model: {n / 1e6:.2f}M params on {self.device}, compute "
            f"{model_cfg.dtype}")
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _put(self, batch) -> list[dict]:
        """Host batch -> ``grad_accum_steps`` micro-batch dicts on the device,
        the batch of ``mp`` rank 0 on every rank of the replica. On CUDA the
        copy (and the broadcast) runs from pinned memory on a side stream."""
        arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
        mp = self.mesh.mp if self.mesh.mp.size > 1 else None
        if self._copy_stream is None:
            tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
            broadcast_first(list(tensors.values()), mp)
        else:
            with torch.cuda.stream(self._copy_stream):
                tensors = {k: torch.from_numpy(v).pin_memory()
                           .to(self.device, non_blocking=True)
                           for k, v in arrays.items()}
                broadcast_first(list(tensors.values()), mp)
        accum = self.cfg.grad_accum_steps
        return [{k: t.chunk(accum)[i] for k, t in tensors.items()}
                for i in range(accum)]

    def _ready(self, micro_batches) -> list[dict]:
        """Make the compute stream wait for the side-stream copy."""
        if self._copy_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._copy_stream)
            for mb in micro_batches:
                for t in mb.values():
                    t.record_stream(cur)
        return micro_batches

    def train(self, max_steps: int | None = None) -> TrainState:
        cfg, state = self.cfg, self.state
        stop = cfg.last_step if max_steps is None else int(max_steps)
        state, resumed = auto_resume(cfg.checkpoint_dir, state)
        if resumed:
            log(f"resumed from {resumed} at step {state.step}")
        logger = MetricsLogger(cfg.checkpoint_dir) if self.writer else None
        it = iter(self.data_iter)
        batch = self._put(next(it))
        last_t = time.perf_counter()
        try:
            while state.step < stop:
                try:
                    nxt = next(it)
                except StopIteration:
                    it = iter(self.data_iter)
                    nxt = next(it)
                current, batch = self._ready(batch), self._put(nxt)
                metrics = train_step(state, current, cfg)
                step = state.step
                if step % cfg.log_every == 0:
                    now = time.perf_counter()
                    metrics["iter_time"] = now - last_t
                    metrics["lr"] = lr_at(step, cfg.lr, cfg.warmup, cfg.train_steps)
                    last_t = now
                    if logger is not None:
                        logger.log(metrics, step)
                    if self.writer and step % cfg.print_every == 0:
                        log(f"step {step}: loss={metrics['loss']:.6f} "
                            f"grad_norm={metrics['grad_norm']:.4f} "
                            f"lr={metrics['lr']:.2e} "
                            f"iter={metrics['iter_time'] * 1000:.0f}ms")
                if step % cfg.checkpoint_every == 0 or step == stop:
                    path = save_checkpoint(cfg.checkpoint_dir, state)
                    if self.writer:
                        log(f"saved checkpoint {path}")
        finally:
            if logger is not None:
                logger.close()
        return state
