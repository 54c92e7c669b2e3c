"""Voxel-locality masks for turbo multiview attention.

Position maps are pooled into per-cell mean 3D positions, and multiview
attention is restricted to the pairs of cells (across all views) whose
means lie within one voxel diagonal ``1.73 / g``:

- :func:`voxel_positions` / :func:`multi_resolution_positions`: the implicit
  form, ``(positions, radius)`` per token, which K7
  (:func:`motion324_tpu_torch.ops.masked_attention.masked_flash_attention`)
  turns into the mask tile by tile;
- :func:`voxel_grid_mask` / :func:`multi_resolution_mask`: the dense
  ``(B, S, S)`` boolean form, for tests and as K7's yardstick.

The multi-resolution forms are keyed by joint token count, the key the
UNet's multiview attention looks its mask up by.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["VoxelMask", "voxel_grid_mask", "multi_resolution_mask",
           "voxel_positions", "multi_resolution_positions"]


@dataclasses.dataclass
class VoxelMask:
    """The implicit mask: ``(B, S, 3)`` cell positions and the radius."""

    positions: torch.Tensor
    radius: float


def _cell_means(position: torch.Tensor, grid_resolution: int):
    """``(B, N, H, W, 3)`` positions in [0, 1], background exactly 1.0 ->
    per-cell means ``(B, N, G, G, 3)``, cells with fewer than 5 valid pixels
    set to 0, and the valid counts."""
    b, n, h, w, _ = position.shape
    g = grid_resolution
    valid = (position != 1.0).all(-1, keepdim=True)
    pos = torch.where(valid, position, torch.zeros_like(position))
    summed = pos.reshape(b, n, g, h // g, g, w // g, 3).sum((3, 5))
    count = valid.reshape(b, n, g, h // g, g, w // g, 1).sum((3, 5))
    mean = summed / count.clamp(min=1)
    return torch.where(count >= 5, mean, torch.zeros_like(mean)), count


def voxel_grid_mask(position: torch.Tensor, grid_resolution: int = 8):
    """``(B, N, H, W, 3)`` position maps -> ``(B, N*L, N*L)`` bool mask
    (``L = g^2``), True where the cell means are within ``1.73 / g``."""
    b, n = position.shape[:2]
    mean, _ = _cell_means(position, grid_resolution)
    cells = mean.reshape(b, n * grid_resolution ** 2, 3)
    dist = torch.linalg.norm(cells[:, :, None] - cells[:, None], dim=-1)
    return dist < (1.73 / grid_resolution)


def multi_resolution_mask(position_maps, grid_resolutions=(32, 16, 8)):
    """Dict keyed by joint token count -> ``(B, T, T)`` masks."""
    out = {}
    for g in grid_resolutions:
        m = voxel_grid_mask(position_maps, g)
        out[m.shape[1]] = m
    return out


def voxel_positions(position: torch.Tensor, grid_resolution: int = 8):
    """``(B, N, H, W, 3)`` position maps -> ``((B, N*L, 3) cell means,
    radius)``, the implicit form of :func:`voxel_grid_mask`."""
    b, n = position.shape[:2]
    g = grid_resolution
    mean, _ = _cell_means(position, g)
    return mean.reshape(b, n * g * g, 3), 1.73 / g


def multi_resolution_positions(position_maps, grid_resolutions=(32, 16, 8)):
    """Dict keyed by joint token count -> :class:`VoxelMask`."""
    out = {}
    for g in grid_resolutions:
        pos, radius = voxel_positions(position_maps, g)
        out[pos.shape[1]] = VoxelMask(pos, radius)
    return out
