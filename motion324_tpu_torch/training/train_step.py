"""One training step (counterpart of the ``shard_map`` and ``gspmd`` paths of
``motion324_tpu/training/train_step.py``), on one device or on every rank
of a ``(dp, mp)`` mesh.

- Gradients are summed over the micro-batches in ``grad_accum_dtype``
  (float32, or bfloat16 to halve the accumulator's traffic), then cast back
  to the parameters' dtype and divided by their number.
- Data parallelism (``parallel_mode`` ``shard_map``, or ``gspmd`` over
  ``mesh.dp``): each rank takes its share of the batch; the gradients are
  averaged over ``dp`` in one flat buffer, as the JAX step's ``pmean``, in
  bf16 on the wire with ``bf16_grad_allreduce`` (on one device the
  gradients still make that bf16 round trip); the loss and ``xyz_loss``
  are averaged too. The model is not wrapped in ``DistributedDataParallel``:
  its reducer fires on ``.backward()`` into ``.grad``, and this step takes
  its gradients with ``torch.autograd.grad``. The dropout generator's seed
  takes the rank's ``dp`` index, as the JAX step folds it into its key.
- Tensor parallelism (``gspmd`` over ``mesh.mp``): the model holds this
  rank's shards (:mod:`motion324_tpu_torch.parallel.tp`); the global norm
  adds the squares of the sharded gradients over ``mp`` to those of the
  replicated ones, taken once, so every rank takes the same decision.
- Pipeline parallelism (``pp``, ``_build_pp_step`` of the JAX package): the
  model holds its stage of the alternating stack over ``mesh.mp``
  (:mod:`motion324_tpu_torch.parallel.pp`), ``pp_microbatches`` split the
  batch and ``grad_accum_steps`` must be 1. The loss is counted on the last
  stage only; the gradients outside the stack are summed over the stages
  (each path contributed on one), the stack's stay on their stage; the
  loss is summed over the stages, then DP's mean runs over ``dp``. The
  global norm adds the stack's squares over the stages to the rest's,
  taken once.
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
from motion324_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                      mean_over, sum_over)
from motion324_tpu_torch.parallel.distributed import is_initialized
from motion324_tpu_torch.parallel.mesh import Group, Mesh
from motion324_tpu_torch.parallel.pp import splits_over_mp
from motion324_tpu_torch.training.loss import coord_mse_loss
from motion324_tpu_torch.training.optimizer import create_optimizer, lr_at
from motion324_tpu_torch.utils.logging import log

__all__ = ["TrainState", "create_train_state", "check_parallel",
           "train_step", "ACCUM_DTYPES"]

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the dropout seed's stride between data-parallel ranks
_DP_SEED_STRIDE = 1_000_000_007


@dataclasses.dataclass
class TrainState:
    """The model holds the parameters, the optimizer their AdamW state."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0          # forward/backward passes
    update_step: int = 0   # applied parameter updates
    mesh: Mesh = dataclasses.field(default_factory=lambda: Mesh(Group(), Group()))


def check_parallel(cfg: TrainConfig, world: int | None = None) -> None:
    """Raise for what the port does not train: an unknown mode, pipeline
    parallelism with accumulation, and a mesh (``mesh.dp`` x ``mesh.mp``)
    that the world's ``world`` processes (default: the process group's
    size, 1 without one) cannot hold."""
    if cfg.parallel_mode == "pp" and cfg.grad_accum_steps != 1:
        raise ValueError("pp mode expresses accumulation via pp_microbatches;"
                         " set grad_accum_steps=1")
    if cfg.parallel_mode not in ("shard_map", "gspmd", "pp"):
        raise ValueError(f"training.parallel_mode={cfg.parallel_mode!r} is not "
                         "one of 'shard_map', 'gspmd', 'pp'")
    if world is None:
        world = torch.distributed.get_world_size() if is_initialized() else 1
    dp, mp = cfg.mesh_dp, cfg.mesh_mp
    if cfg.parallel_mode == "shard_map" and mp != 1:
        raise ValueError(f"mesh.mp={mp}: parallel_mode 'shard_map' is data "
                         "parallel only; tensor parallelism is 'gspmd'")
    if dp == -1 and world % mp:
        raise ValueError(f"mesh.mp={mp} needs a world size divisible by {mp}; "
                         f"the world size is {world}")
    if dp != -1 and dp * mp != world:
        raise ValueError(f"mesh.dp x mesh.mp = {dp} x {mp} needs a world size "
                         f"of {dp * mp}; the world size is {world}")
    if cfg.grad_accum_dtype not in ACCUM_DTYPES:
        raise ValueError("training.grad_accum_dtype must be 'float32' or "
                         f"'bfloat16', got {cfg.grad_accum_dtype!r}")


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       mesh: Mesh | None = None) -> TrainState:
    """Freeze the image encoder, set block recomputation from
    ``training.remat`` and build AdamW over the trainable parameters.
    ``mesh``: the ``(dp, mp)`` mesh the step runs on (none: one device);
    under tensor parallelism the model must be built with ``mesh.mp``."""
    mesh = mesh or Mesh(Group(), Group())
    check_parallel(cfg, mesh.dp.size * mesh.mp.size)
    if mesh.mp.size > 1:
        kind = "pp" if cfg.parallel_mode == "pp" else "tp"
        if getattr(model, kind, None) != mesh.mp:
            raise ValueError(f"parallel_mode {cfg.parallel_mode!r} over mp "
                             f"needs the model built with {kind}=mesh.mp")
    model.remat = cfg.remat
    if cfg.remat and cfg.remat_policy:
        log(f"training.remat_policy={cfg.remat_policy!r} is a TPU memory "
            "schedule and is not applied; every block is recomputed")
    opt = create_optimizer(model, lr=cfg.lr, beta1=cfg.beta1, beta2=cfg.beta2,
                           weight_decay=cfg.weight_decay)
    return TrainState(model, opt, mesh=mesh)


def _params(state: TrainState) -> list[torch.Tensor]:
    return [p for g in state.optimizer.param_groups for p in g["params"]]


def _split_over_mp(state: TrainState, params) -> list[bool]:
    """Whether each parameter differs across ``mp``: a tensor-parallel
    shard, or a pipeline stage's pair."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [splits_over_mp(state.model, names[id(p)]) for p in params]


def _loss_weight(pp: Group | None) -> float:
    """The weight of this rank's loss: a pipeline counts it on its last
    stage only, so that each replicated path's gradient appears on one
    stage before the sum over the stages."""
    return 1.0 if pp is None or pp.rank == pp.size - 1 else 0.0


def _global_norm(state: TrainState, params, grads) -> torch.Tensor:
    """The norm of the whole model's gradient: the squares of the
    gradients that differ across ``mp`` (tensor-parallel shards, pipeline
    stages) summed over it, plus those of the replicated ones, once."""
    tp = state.mesh.mp
    sharded = _split_over_mp(state, params)
    sq = [g.float().pow(2).sum() for g in grads]
    zero = torch.zeros((), device=grads[0].device)
    part = torch.stack([x for x, s in zip(sq, sharded) if s] or [zero]).sum()
    whole = torch.stack([x for x, s in zip(sq, sharded) if not s] or [zero]).sum()
    return (all_reduce_sum(part, tp) + whole).sqrt()


def train_step(state: TrainState, micro_batches, cfg: TrainConfig,
               generator: torch.Generator | None = None) -> dict[str, float]:
    """One step over ``micro_batches`` (a sequence of sample dicts on the
    model's device; their number is the accumulation count). Updates
    ``state`` in place and returns ``loss``, ``xyz_loss``, ``grad_norm`` and
    ``skipped``. The dropout mask comes from ``generator``, by default one
    seeded from ``training.seed``, the step and the rank's ``dp`` index.
    On a mesh, ``micro_batches`` are this rank's share of the batch; the
    returned loss and norm are the whole batch's."""
    model = state.model
    params = _params(state)
    dp = state.mesh.dp
    pp = state.mesh.mp if getattr(model, "pp", None) is not None else None
    mask = _loss_weight(pp)
    if generator is None:
        device = params[0].device
        generator = torch.Generator(device=device).manual_seed(
            cfg.seed * 1_000_003 + state.step + _DP_SEED_STRIDE * dp.rank)
    accum = len(micro_batches)
    acc_dtype = ACCUM_DTYPES[cfg.grad_accum_dtype]
    grads = loss = xyz = None
    for mb in micro_batches:
        pred = model(mb, train=True, generator=generator)
        l, m = coord_mse_loss(pred, mb["point_clouds"], cfg.coord_mse_loss_weight)
        l, m = l * mask, {k: v * mask for k, v in m.items()}
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
    if pp is not None:
        # the stack's gradients stay on their stage; the rest, and the
        # loss, summed over the stages
        stage = _split_over_mp(state, params)
        shared = sum_over(pp, [g for g, s in zip(grads, stage) if not s])
        grads = [g if s else shared.pop(0) for g, s in zip(grads, stage)]
        loss, xyz = sum_over(pp, [loss, xyz])
    grads = mean_over(dp, grads,
                      torch.bfloat16 if cfg.bf16_grad_allreduce else None)
    loss, xyz = mean_over(dp, [loss, xyz])
    grads = [torch.nan_to_num(g, nan=0.0, posinf=1e-6, neginf=-1e-6)
             for g in grads]
    gnorm = _global_norm(state, params, grads)
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
