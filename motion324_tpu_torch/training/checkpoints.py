"""Checkpoint save, auto-resume and params-only restore with ``torch.save``
(counterpart of ``motion324_tpu/training/checkpoints.py``).

A checkpoint is the directory ``ckpt_dir/ckpt_{update_step:016d}`` holding
``state.pt``: ``{params, opt_state, step, update_step}``, where ``params`` is
the model's state dict (reference parameter names) and ``opt_state`` the
optimizer's. It is named by the applied updates, as the reference names its
``ckpt_{param_update_step:016d}.pt``.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn

from motion324_tpu_torch.training.train_step import TrainState

__all__ = ["save_checkpoint", "find_checkpoints", "latest_checkpoint",
           "auto_resume", "restore_params"]

_CKPT_RE = re.compile(r"^ckpt_(\d{16})$")
_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write ``state`` to ``ckpt_dir/ckpt_{update_step:016d}`` and return
    that directory. The file is written under another name and renamed, so
    a crash leaves no partial checkpoint behind."""
    path = os.path.abspath(os.path.join(ckpt_dir,
                                        f"ckpt_{state.update_step:016d}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save({"params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict(),
                "step": state.step, "update_step": state.update_step}, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
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
    state.model.load_state_dict(saved["params"])
    if not reset_training_state:
        state.optimizer.load_state_dict(saved["opt_state"])
        state.step = int(saved["step"])
        state.update_step = int(saved["update_step"])
    return state, path


def restore_params(path: str, model: nn.Module) -> nn.Module:
    """Load the parameters of a checkpoint directory (or of a ``.pt`` file
    holding a bare state dict) into ``model``, cast to its dtype, for
    inference."""
    saved = _load(path, next(model.parameters()).device)
    sd = saved.get("params", saved)
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    model.load_state_dict({k: v.to(dtypes.get(k, v.dtype)) for k, v in sd.items()})
    return model
