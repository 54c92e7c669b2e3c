"""Flow-matching Euler scheduler (functional).

Reproduces the reference's reversed-timestep flow matching (reference:
scripts/hy3dgen/shapegen/schedulers.py:81-321 and pipelines.py:718-758):
the pipeline passes ``sigmas = linspace(0, 1, steps)``, a shift transform
``s' = shift * s / (1 + (shift - 1) * s)`` is applied, a terminal 1.0 is
appended, and each Euler step is ``x <- x + (sigma_next - sigma) * v``.
State-free: arrays and a step function, for numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["flow_match_sigmas", "consistency_flow_match_sigmas", "euler_step",
           "scale_noise"]


def flow_match_sigmas(num_steps: int, shift: float = 1.0) -> np.ndarray:
    """Sigma ladder of length ``num_steps + 1`` (terminal 1.0 appended)."""
    sigmas = np.linspace(0.0, 1.0, num_steps, dtype=np.float32)
    if shift != 1.0:
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return np.concatenate([sigmas, np.ones(1, np.float32)])


def consistency_flow_match_sigmas(num_steps: int,
                                  num_train_timesteps: int = 1000,
                                  pcm_timesteps: int = 50) -> np.ndarray:
    """Sigma ladder for consistency (PCM-distilled) flow matching.

    Reproduces ``ConsistencyFlowMatchEulerDiscreteScheduler`` (reference
    schedulers.py:335-415): the train-time sigma grid is subsampled to
    ``pcm_timesteps`` segment boundaries, inference picks ``num_steps`` of
    those (linspace without endpoint), and a terminal 1.0 is appended. The
    Euler update is identical to :func:`euler_step`.
    """
    sigmas = np.linspace(0.0, 1.0, num_train_timesteps, dtype=np.float64)
    step_ratio = num_train_timesteps // pcm_timesteps
    euler_ts = (np.arange(1, pcm_timesteps) * step_ratio).round().astype(np.int64) - 1
    euler_ts = np.concatenate([[0], euler_ts])
    grid = sigmas[euler_ts]
    idx = np.linspace(0, pcm_timesteps, num=num_steps,
                      endpoint=False).astype(np.int64)
    chosen = grid[np.clip(idx, 0, len(grid) - 1)]
    return np.concatenate([chosen, np.ones(1)]).astype(np.float32)


def euler_step(sample, velocity, sigma, sigma_next):
    """One Euler step of the probability-flow ODE (schedulers.py:305-307)."""
    return sample + (sigma_next - sigma) * velocity


def scale_noise(sample, noise, sigma):
    """Forward interpolation ``sigma * noise + (1 - sigma) * sample``
    (schedulers.py:127-173)."""
    return sigma * noise + (1.0 - sigma) * sample
