"""Trajectory smoothing (host-side numpy, vectorised).

Behavioural parity with the reference smoothing stack (reference:
utils/inference_utils.py:99-195), with the per-point Python loops replaced by
vectorised operations:

- ``threshold``: freeze points whose frame-to-frame displacement is below
  ``motion_threshold`` (sequential propagation over T, as in the reference);
- ``gaussian``: per-point gaussian_filter1d over time (mode='nearest');
- ``savgol``: Savitzky-Golay filter over time;
- ``oneeuro``: One-Euro filter (reference :58-96), vectorised over points;
- ``combined``: threshold then gaussian (the shipped default, called with
  motion_threshold=0.002, sigma=1.0 — scripts/inference_with_video_mesh.py:395-405).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import savgol_filter

__all__ = ["smooth_trajectories", "OneEuroFilter"]


class OneEuroFilter:
    """Vectorised One-Euro filter; state arrays track every signal at once."""

    def __init__(self, mincutoff: float = 1.0, beta: float = 0.007,
                 dcutoff: float = 1.0):
        self.mincutoff = mincutoff
        self.beta = beta
        self.dcutoff = dcutoff
        self.x_prev = None
        self.dx_prev = 0.0

    @staticmethod
    def smoothing_factor(te, cutoff):
        r = 2 * np.pi * cutoff * te
        return r / (r + 1)

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        if self.x_prev is None:
            self.x_prev = x
            self.dx_prev = np.zeros_like(x)
            return x
        dx = x - self.x_prev
        alpha_d = self.smoothing_factor(1.0, self.dcutoff)
        dx_hat = alpha_d * dx + (1 - alpha_d) * self.dx_prev
        cutoff = self.mincutoff + self.beta * np.abs(dx_hat)
        alpha = self.smoothing_factor(1.0, cutoff)
        x_hat = alpha * x + (1 - alpha) * self.x_prev
        self.x_prev = x_hat
        self.dx_prev = dx_hat
        return x_hat


def smooth_trajectories(trajs: np.ndarray, method: str = "combined",
                        motion_threshold: float = 0.005, window_size: int = 3,
                        sigma: float = 1.0, savgol_polyorder: int = 2,
                        oneeuro_mincutoff: float = 1.0,
                        oneeuro_beta: float = 0.007) -> np.ndarray:
    """Smooth ``(B, T, N, 3)`` trajectories; returns a new array."""
    trajs = np.asarray(trajs, np.float32)
    if trajs.ndim != 4:
        raise ValueError(f"expected (B,T,N,3), got {trajs.shape}")
    out = trajs.copy()
    b, t_frames, n, _ = trajs.shape

    if method in ("threshold", "combined"):
        # sequential: freezing at t compares the ORIGINAL t against smoothed t-1
        # being propagated (reference freezes against trajs[b, t-1] original and
        # copies trajs_smoothed[t-1] — displacement measured on raw trajs).
        for t in range(1, t_frames):
            disp = np.linalg.norm(trajs[:, t] - trajs[:, t - 1], axis=-1)
            mask = disp < motion_threshold  # (B, N)
            out[:, t] = np.where(mask[..., None], out[:, t - 1], out[:, t])

    if method in ("gaussian", "combined"):
        out = gaussian_filter1d(out, sigma=sigma, axis=1, mode="nearest")

    if method == "savgol":
        w = window_size + (window_size % 2 == 0)
        if t_frames >= w:
            out = savgol_filter(out, window_length=w,
                                polyorder=min(savgol_polyorder, w - 1),
                                axis=1, mode="nearest")

    if method == "oneeuro":
        filt = OneEuroFilter(mincutoff=oneeuro_mincutoff, beta=oneeuro_beta)
        res = np.empty_like(out)
        for t in range(t_frames):
            res[:, t] = filt(out[:, t])
        out = res.astype(np.float32)

    return out.astype(np.float32)
