"""Training loss: weighted coordinate MSE over ``(B, T, N, 3)`` trajectories
(counterpart of ``motion324_tpu/training/loss.py``)."""

from __future__ import annotations

import torch

__all__ = ["coord_mse_loss"]


def coord_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                   weight: float = 1.0):
    """``(loss, metrics)``: ``weight * mse`` in f32, and ``metrics`` with
    ``loss`` and the unweighted ``xyz_loss``."""
    if pred.shape != target.shape or pred.dim() != 4:
        raise ValueError(f"expected matching (B,T,N,C) shapes, got "
                         f"{tuple(pred.shape)} vs {tuple(target.shape)}")
    mse = torch.mean((pred.float() - target.float()) ** 2)
    loss = weight * mse
    return loss, {"loss": loss, "xyz_loss": mse}
