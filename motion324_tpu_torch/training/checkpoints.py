"""Checkpoint save, auto-resume and params-only restore with ``torch.save``
(counterpart of ``motion324_tpu/training/checkpoints.py``).

A checkpoint is the directory ``ckpt_dir/ckpt_{update_step:016d}`` holding
``state.pt``: ``{params, opt_state, step, update_step}``, where ``params`` is
the model's state dict (reference parameter names) and ``opt_state`` the
optimizer's. It is named by the applied updates, as the reference names its
``ckpt_{param_update_step:016d}.pt``.

On a mesh the file holds the whole model, whatever ``(dp, mp)`` and mode
wrote it: the tensor-parallel shards of the parameters and of AdamW's
moments, or the pipeline stages' pairs of both (renumbered, and the
optimizer's entries put in the whole model's order), are gathered over
``mp`` and global rank 0 writes, behind a barrier. Every rank resumes from
the whole state and cuts its own shard or stage again, so a checkpoint
written at any ``(dp, mp)`` and mode resumes at any other, and on one
device.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist
from torch import nn

from motion324_tpu_torch.parallel.distributed import is_initialized
from motion324_tpu_torch.parallel.pp import (gather_stages, model_part,
                                             model_whole, whole_name,
                                             whole_names)
from motion324_tpu_torch.parallel.tp import shard_tensor, tp_rule
from motion324_tpu_torch.training.train_step import TrainState

__all__ = ["save_checkpoint", "find_checkpoints", "latest_checkpoint",
           "auto_resume", "restore_params"]

_CKPT_RE = re.compile(r"^ckpt_(\d{16})$")
_FILE = "state.pt"


def _opt_names(state: TrainState) -> list[str]:
    """The parameter name of each index of the optimizer's state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _moments(state: TrainState, sd: dict, cut) -> dict:
    """``sd`` (an optimizer state dict) with ``cut(tensor, name)`` applied
    to the AdamW moments of every parameter; the live state is not
    touched."""
    names = _opt_names(state)
    out = dict(sd)
    out["state"] = {i: {**s, **{m: cut(s[m], names[int(i)]) for m in _MOMENTS
                               if m in s}}
                    for i, s in sd["state"].items()}
    return out


def _stages(state: TrainState) -> tuple:
    """``(pipeline group, pairs per stage)`` of a pipeline stage's state,
    else ``(None, 0)``."""
    pp = getattr(state.model, "pp", None)
    return (pp, len(state.model.global_transformer_blocks)) if pp else (None, 0)


def _whole_groups(state: TrainState, sd: dict) -> list[list[str]]:
    """The whole model's parameter names of each of a pipeline stage's
    optimizer state dict ``sd``'s groups, in order."""
    names = _opt_names(state)
    pp, k = _stages(state)
    return [whole_names([names[i] for i in g["params"]], pp.size, k)
            for g in sd["param_groups"]]


def _gather_pp_optimizer(state: TrainState) -> dict:
    """The whole model's optimizer state dict from a pipeline stage's: the
    moments of every stage's pairs gathered and indexed as the whole model's
    optimizer indexes them (a collective over the pipeline group)."""
    pp, k = _stages(state)
    names = _opt_names(state)
    sd = state.optimizer.state_dict()
    mine = {names[int(i)]: s for i, s in sd["state"].items()}
    moments = {m: gather_stages({n: s[m] for n, s in mine.items() if m in s},
                                pp, k) for m in _MOMENTS}
    local = {w: n for n in names for w in whole_names([n], pp.size, k)}
    out, groups, i = {}, [], 0
    for g, wnames in zip(sd["param_groups"], _whole_groups(state, sd)):
        groups.append({**g, "params": list(range(i, i + len(wnames)))})
        for w in wnames:
            if local[w] in mine:
                out[i] = {**mine[local[w]], **{m: moments[m][w]
                                               for m in _MOMENTS if w in moments[m]}}
            i += 1
    return {"state": out, "param_groups": groups}


def _stage_optimizer(state: TrainState, saved: dict) -> dict:
    """A pipeline stage's optimizer state dict from the whole model's
    ``saved``: each of its parameters takes the entry of its whole name."""
    pp, k = _stages(state)
    sd = state.optimizer.state_dict()
    index = {w: j for g, wnames in zip(saved["param_groups"],
                                       _whole_groups(state, sd))
             for w, j in zip(wnames, g["params"])}
    out = {}
    for i, n in enumerate(_opt_names(state)):
        w = whole_name(n, pp.rank, k)
        if index[w] in saved["state"]:
            out[i] = saved["state"][index[w]]
    groups = [{**sg, "params": g["params"]}
              for g, sg in zip(sd["param_groups"], saved["param_groups"])]
    return {"state": out, "param_groups": groups}


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write ``state`` to ``ckpt_dir/ckpt_{update_step:016d}`` and return
    that directory. The file is written under another name and renamed, so
    a crash leaves no partial checkpoint behind. On a mesh every rank calls
    this; the model replica of ``dp`` index 0 gathers its shards and global
    rank 0 writes them."""
    path = os.path.abspath(os.path.join(ckpt_dir,
                                        f"ckpt_{state.update_step:016d}"))
    if state.mesh.dp.rank == 0:
        model = state.model
        params = model_whole(model, model.state_dict())
        if _stages(state)[0] is not None:
            opt = _gather_pp_optimizer(state)
        else:
            opt = _moments(state, state.optimizer.state_dict(),
                           lambda v, name: model_whole(model, {name: v})[name])
        if not is_initialized() or dist.get_rank() == 0:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, _FILE + ".tmp")
            torch.save({"params": params, "opt_state": opt,
                        "step": state.step, "update_step": state.update_step},
                       tmp)
            os.replace(tmp, os.path.join(path, _FILE))
    if is_initialized():
        dist.barrier()
    return path


def find_checkpoints(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [os.path.join(ckpt_dir, n) for n in sorted(os.listdir(ckpt_dir))
            if _CKPT_RE.match(n) and os.path.exists(os.path.join(ckpt_dir, n, _FILE))]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    found = find_checkpoints(ckpt_dir)
    return found[-1] if found else None


def _load(path: str, device) -> dict:
    f = os.path.join(path, _FILE) if os.path.isdir(path) else path
    return torch.load(f, map_location=device, weights_only=True)


def auto_resume(ckpt_dir: str, state: TrainState, *,
                reset_training_state: bool = False):
    """Restore the latest checkpoint in ``ckpt_dir`` into ``state`` in place.
    With ``reset_training_state`` only the parameters are restored; the
    optimizer and the counters stay fresh. Returns ``(state, path or None)``."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return state, None
    device = next(state.model.parameters()).device
    saved = _load(path, device)
    tp = state.mesh.mp
    state.model.load_state_dict(model_part(state.model, saved["params"]))
    if not reset_training_state and _stages(state)[0] is not None:
        state.optimizer.load_state_dict(_stage_optimizer(state,
                                                         saved["opt_state"]))
    elif not reset_training_state:
        state.optimizer.load_state_dict(_moments(
            state, saved["opt_state"],
            lambda v, name: shard_tensor(v, tp_rule(name), tp.rank, tp.size,
                                         name)))
        state.step = int(saved["step"])
        state.update_step = int(saved["update_step"])
    return state, path


def restore_params(path: str, model: nn.Module) -> nn.Module:
    """Load the parameters of a checkpoint directory (or of a ``.pt`` file
    holding a bare state dict) into ``model``, cast to its dtype, for
    inference; a tensor-parallel model takes its shard, a pipeline stage
    its pairs."""
    saved = _load(path, next(model.parameters()).device)
    sd = model_part(model, saved.get("params", saved))
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    model.load_state_dict({k: v.to(dtypes.get(k, v.dtype)) for k, v in sd.items()})
    return model
