"""Trajectory smoothing and the Blender remap, ``csrc/smooth_traj.cu``, and
its plain version.

Replaces no TPU kernel: the JAX package smooths on the host in numpy
(``motion324_tpu/inference/smoothing.py`` ``smooth_trajectories``, then
``to_blender_coords``). The kernel was added so that the model's ``(B, T,
N, 3)`` trajectory field is finished where it is made: on the host the
freeze scan, scipy's line-by-line Gaussian and the remap's copies walked a
256-frame clip's field frame by frame, about half a second while the card
idled. Its bound is bytes: the field read once and written once, ``2 *
B*T*N*12`` bytes (124 MB, 37 us at 3.35 TB/s, at (1, 256, 20 164)).

The function, in the methods of ``smooth_trajectories`` that it takes
(:data:`METHODS`), followed by ``(x, y, z) -> (x, -z, y)``:

- ``"threshold"``: a point keeps its previous output frame where its raw
  step ``|x[t] - x[t-1]|`` (f32, rounded as numpy's norm rounds it) lies
  below ``motion_threshold``;
- ``"gaussian"``: scipy's ``gaussian_filter1d`` over time (``truncate=4``,
  ``mode="nearest"``), in f64 with scipy's taps and order of sums, rounded
  to f32 once;
- ``"combined"``: the first, then the second (the shipped default);
- ``"none"``: the remap alone.

Both versions equal ``smooth_trajectories`` followed by
``to_blender_coords`` bit for bit. ``"savgol"`` and ``"oneeuro"`` stay on
the host: numpy's ``smooth_trajectories``.

:func:`smooth_traj` launches the kernel on a CUDA tensor (counted in
``smooth_traj.launches``) and computes :func:`smooth_traj_reference` on a
CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from motion324_tpu_torch.ops import _build

__all__ = ["smooth_traj", "smooth_traj_reference", "gaussian_taps",
           "METHODS", "MAX_RADIUS"]

METHODS = ("none", "threshold", "gaussian", "combined")
MAX_RADIUS = 8      # the kernel's largest Gaussian radius (sigma up to 2)
_lib: ctypes.CDLL | None = None


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The half kernel ``w[0..r]`` (f64, ``w[0]`` the centre) of scipy's
    ``gaussian_filter1d``: radius ``int(truncate * sigma + 0.5)``, computed
    as scipy's ``_gaussian_kernel1d`` computes it."""
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, not {sigma}")
    r = int(truncate * float(sigma) + 0.5)
    x = np.arange(-r, r + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum())[r:]


def _plan(field: torch.Tensor, method: str, sigma: float):
    """(freeze, taps) of a call; raises on what neither version takes."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, not {method!r} "
                         f"(savgol and oneeuro: inference.smoothing."
                         f"smooth_trajectories on the host)")
    if field.dim() != 4 or field.shape[-1] != 3 or 0 in field.shape:
        raise ValueError(f"expected a (B, T, N, 3) field with B, T, N >= 1, "
                         f"got {tuple(field.shape)}")
    if field.dtype != torch.float32:
        raise TypeError(f"the field must be float32, not {field.dtype}")
    taps = (gaussian_taps(sigma) if method in ("gaussian", "combined")
            else np.ones(1))
    return method in ("threshold", "combined"), taps


def smooth_traj_reference(field: torch.Tensor, method: str = "combined",
                          motion_threshold: float = 0.002,
                          sigma: float = 1.0) -> torch.Tensor:
    """The plain version: ``(B, T, N, 3)`` f32 -> the field smoothed by
    ``method`` and remapped to ``(x, -z, y)``, on the field's device."""
    freeze, taps = _plan(field, method, sigma)
    frames = field.shape[1]
    kept = field
    if freeze:
        kept = field.clone()
        threshold = torch.tensor(motion_threshold, dtype=torch.float32,
                                 device=field.device)
        for t in range(1, frames):
            d = field[:, t] - field[:, t - 1]
            sq = d * d
            step = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]).sqrt()
            kept[:, t] = torch.where((step < threshold)[..., None],
                                     kept[:, t - 1], field[:, t])
    r = len(taps) - 1
    if r:
        x = kept.double()

        def shifted(j):      # frames t + j, clamped (mode "nearest")
            idx = (torch.arange(frames, device=field.device) + j).clamp(
                0, frames - 1)
            return x[:, idx]
        acc = x * float(taps[0])
        for j in range(r, 0, -1):
            acc = acc + (shifted(-j) + shifted(j)) * float(taps[j])
        kept = acc.float()
    return torch.stack([kept[..., 0], -kept[..., 2], kept[..., 1]], -1)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("smooth_traj")
        lib.m324_smooth_traj.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        lib.m324_smooth_traj.restype = ctypes.c_int
        _lib = lib
    return _lib


def smooth_traj(field: torch.Tensor, method: str = "combined",
                motion_threshold: float = 0.002,
                sigma: float = 1.0) -> torch.Tensor:
    """``(B, T, N, 3)`` f32 -> smoothed by ``method`` and remapped to ``(x,
    -z, y)``: the kernel, in one launch, on a contiguous CUDA tensor; the
    plain version on a CPU tensor."""
    if field.device.type == "cpu":
        return smooth_traj_reference(field, method, motion_threshold, sigma)
    if field.device.type != "cuda":
        raise ValueError(f"smooth_traj runs on cuda or cpu, not {field.device}")
    freeze, taps = _plan(field, method, sigma)
    if not field.is_contiguous():
        raise ValueError("the smoothing kernel takes a contiguous field")
    r = len(taps) - 1
    if r > MAX_RADIUS:
        raise ValueError(f"the smoothing kernel's Gaussian reaches radius "
                         f"{MAX_RADIUS} (sigma <= 2), not {r}")
    b, t, n, _ = field.shape
    out = torch.empty_like(field)
    w = (ctypes.c_double * (r + 1))(*taps)
    with torch.cuda.device(field.device):
        rc = _load().m324_smooth_traj(
            field.data_ptr(), out.data_ptr(), b, t, n, int(freeze),
            motion_threshold, r, w,
            torch.cuda.current_stream(field.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"smooth_traj launch failed: CUDA error {rc}")
    smooth_traj.launches += 1
    return out


smooth_traj.launches = 0
