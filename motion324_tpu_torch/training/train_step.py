"""One training step on one device (counterpart of the ``shard_map`` path of
``motion324_tpu/training/train_step.py``).

- Gradients are summed over the micro-batches in ``grad_accum_dtype``
  (float32, or bfloat16 to halve the accumulator's traffic), then cast back
  to the parameters' dtype and divided by their number.
- ``bf16_grad_allreduce`` keeps the bf16 round trip that the JAX step
  applies to the gradients before its all-reduce, even on one device.
- Hygiene: ``nan_to_num(0, +-1e-6)`` on every gradient.
- The pre-clip global norm decides the step: it is skipped when the loss is
  not finite or the norm exceeds ``allowed_gradnorm_factor * grad_clip_norm``.
  Otherwise gradients are scaled by ``min(1, clip / (norm + 1e-6))`` and
  AdamW takes one update at the schedule's rate for the number of updates
  applied so far.
- ``step`` counts forward/backward passes and always advances;
  ``update_step``, the parameters and the optimizer state move only when the
  step is not skipped.

Unlike the JAX step, which selects the new state on the device, this one
reads the skip decision on the host (one synchronisation per step).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from motion324_tpu_torch.config import TrainConfig
from motion324_tpu_torch.training.loss import coord_mse_loss
from motion324_tpu_torch.training.optimizer import create_optimizer, lr_at
from motion324_tpu_torch.utils.logging import log

__all__ = ["TrainState", "create_train_state", "check_single_device",
           "train_step", "ACCUM_DTYPES"]

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """The model holds the parameters, the optimizer their AdamW state."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0          # forward/backward passes
    update_step: int = 0   # applied parameter updates


def check_single_device(cfg: TrainConfig) -> None:
    """Raise for what the port does not train yet: modes other than the
    data-parallel ``shard_map`` one, and more than one device."""
    if cfg.parallel_mode in ("gspmd", "pp"):
        raise NotImplementedError(
            f"training.parallel_mode={cfg.parallel_mode!r} is not ported yet "
            "(ROADMAP Queue 1 item 11); the port trains on one device")
    if cfg.parallel_mode != "shard_map":
        raise ValueError(f"training.parallel_mode={cfg.parallel_mode!r} is not "
                         "one of 'shard_map', 'gspmd', 'pp'")
    multi = (cfg.mesh_dp not in (-1, 1) or cfg.mesh_mp != 1
             or (torch.distributed.is_available()
                 and torch.distributed.is_initialized()
                 and torch.distributed.get_world_size() > 1))
    if multi:
        raise NotImplementedError(
            "training on more than one device is not ported yet (ROADMAP "
            "Queue 1 item 11); set mesh.dp=1 and mesh.mp=1")
    if cfg.grad_accum_dtype not in ACCUM_DTYPES:
        raise ValueError("training.grad_accum_dtype must be 'float32' or "
                         f"'bfloat16', got {cfg.grad_accum_dtype!r}")


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Freeze the image encoder, set block recomputation from
    ``training.remat`` and build AdamW over the trainable parameters."""
    check_single_device(cfg)
    model.remat = cfg.remat
    if cfg.remat and cfg.remat_policy:
        log(f"training.remat_policy={cfg.remat_policy!r} is a TPU memory "
            "schedule and is not applied; every block is recomputed")
    opt = create_optimizer(model, lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
                           weight_decay=cfg.weight_decay)
    return TrainState(model, opt)


def _params(state: TrainState) -> list[torch.Tensor]:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def train_step(state: TrainState, micro_batches, cfg: TrainConfig,
               generator: torch.Generator | None = None) -> dict[str, float]:
    """One step over ``micro_batches`` (a sequence of sample dicts on the
    model's device; their number is the accumulation count). Updates
    ``state`` in place and returns ``loss``, ``xyz_loss``, ``grad_norm`` and
    ``skipped``. The dropout mask comes from ``generator``, by default one
    seeded from ``training.seed`` and the step."""
    model = state.model
    params = _params(state)
    if generator is None:
        device = params[0].device
        generator = torch.Generator(device=device).manual_seed(
            cfg.seed * 1_000_003 + state.step)
    accum = len(micro_batches)
    acc_dtype = ACCUM_DTYPES[cfg.grad_accum_dtype]
    grads = loss = xyz = None
    for mb in micro_batches:
        pred = model(mb, train=True, generator=generator)
        l, m = coord_mse_loss(pred, mb["point_clouds"], cfg.coord_mse_loss_weight)
        g = torch.autograd.grad(l, params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, params)]
        if accum > 1:
            g = [x.to(acc_dtype) for x in g]
        if grads is None:
            grads, loss, xyz = g, l.detach(), m["xyz_loss"].detach()
        else:
            grads = [a + b for a, b in zip(grads, g)]
            loss, xyz = loss + l.detach(), xyz + m["xyz_loss"].detach()
    if accum > 1:
        grads = [g.to(p.dtype) / accum for g, p in zip(grads, params)]
        loss, xyz = loss / accum, xyz / accum
    if cfg.bf16_grad_allreduce:
        grads = [g.to(torch.bfloat16).to(g.dtype) for g in grads]
    grads = [torch.nan_to_num(g, nan=0.0, posinf=1e-6, neginf=-1e-6)
             for g in grads]
    gnorm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    spike = cfg.allowed_gradnorm_factor * cfg.grad_clip_norm
    ok = bool(torch.isfinite(loss) & (gnorm <= spike))
    if ok:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        for p, g in zip(params, grads):
            p.grad = g.mul_(scale.to(g.dtype))
        rate = lr_at(state.update_step, cfg.lr, cfg.warmup, cfg.train_steps)
        for group in state.optimizer.param_groups:
            group["lr"] = rate
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.update_step += 1
    state.step += 1
    return {"loss": float(loss), "xyz_loss": float(xyz),
            "grad_norm": float(gnorm), "skipped": 0.0 if ok else 1.0}
