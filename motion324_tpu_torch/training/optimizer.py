"""AdamW with the decay split and the cosine-with-warmup schedule
(counterpart of ``motion324_tpu/training/optimizer.py``).

- The image encoder (DINOv2) is frozen: its parameters get
  ``requires_grad=False`` and stay out of the optimizer, as optax's
  ``set_to_zero`` branch keeps them out of the updates.
- Weight decay applies to parameters of two or more dimensions (weights,
  tokens); norm scales and biases are exempt, the set of the JAX package's
  ``decay_mask``.
- The schedule is read at the number of APPLIED updates: optax's count lives
  in the optimizer state, which a skipped step does not advance.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["FROZEN_PREFIXES", "lr_at", "freeze_encoder", "decays",
           "create_optimizer"]

FROZEN_PREFIXES = ("image_encoder.",)


def lr_at(step: int, lr: float, warmup: int, train_steps: int) -> float:
    """Linear warmup from 0 to ``lr`` over ``warmup`` steps, then a cosine
    to 0 at ``train_steps`` (HF ``get_cosine_schedule_with_warmup``)."""
    warmup = max(int(warmup), 0)
    if step < warmup:
        return lr * step / max(warmup, 1)
    progress = min(max((step - warmup) / max(train_steps - warmup, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * progress))


def freeze_encoder(model: nn.Module) -> None:
    for name, p in model.named_parameters():
        if name.startswith(FROZEN_PREFIXES):
            p.requires_grad_(False)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether parameter ``name`` receives weight decay."""
    return p.dim() >= 2 and not name.startswith(FROZEN_PREFIXES)


def create_optimizer(model: nn.Module, *, lr: float, beta1: float = 0.9,
                     beta2: float = 0.95, weight_decay: float = 0.05):
    """Freeze the image encoder and return ``torch.optim.AdamW`` over the
    trainable parameters in two groups (decay, no decay). ``lr`` is the peak
    rate; the train step sets each update's rate from :func:`lr_at`."""
    freeze_encoder(model)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[decays(name, p)].append(p)
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=lr, betas=(beta1, beta2), eps=1e-8)
