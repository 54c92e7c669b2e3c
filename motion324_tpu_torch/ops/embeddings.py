"""Point, video and frequency positional embeddings, all in float32.

- :func:`frequency_embed`: per-coordinate ``[x, sin(f x), cos(f x)]`` with
  octave frequencies (the ShapeVAE's query-point embedding).
- :func:`point_embed_basis`: block-diagonal 3D Fourier basis for the point
  embedding (frequencies ``pi * 2^j`` per axis).
- :func:`apply_point_basis`: ``(..., 3)`` points -> ``[sin, cos, xyz]``.
- :func:`video_pos_embed`: 3D Fourier table over a (T, H, W) token grid.
- :func:`resize_pos_embed`: trilinear resample of that table to another grid
  (``align_corners=False``), so a model trained at T=12 runs at any T.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["frequency_embed", "point_embed_basis", "apply_point_basis",
           "video_pos_embed", "resize_pos_embed"]


def frequency_embed(x: torch.Tensor, num_freqs: int = 6, logspace: bool = True,
                    include_input: bool = True,
                    include_pi: bool = True) -> torch.Tensor:
    """``x[..., i] -> [x_i?, sin(f_0 x_i) ... sin(f_{N-1} x_i), cos(...)]``
    with ``f_j = 2^j`` (logspace) or ``linspace(1, 2^{N-1})``, times pi with
    ``include_pi``; output width ``D * (2 num_freqs + include_input)``. Runs
    in x's dtype: pass f32 where the frequencies are high (the ShapeVAE's
    reach 2^7 pi, about 402 rad, where bf16 coordinates lose a radian)."""
    if num_freqs <= 0:
        return x
    # made on x's device: a host table would cost a host-to-device copy,
    # which waits for the stream, on every call
    if logspace:
        freqs = torch.exp2(torch.arange(num_freqs, dtype=x.dtype,
                                        device=x.device))
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    parts = ([x] if include_input else []) + [torch.sin(emb), torch.cos(emb)]
    return torch.cat(parts, dim=-1)


def point_embed_basis(hidden_dim: int = 48) -> np.ndarray:
    """Basis of shape ``(3, hidden_dim // 2)``: row i holds ``pi * 2^j`` in
    coordinate i's own block of columns and zeros elsewhere."""
    assert hidden_dim % 6 == 0
    n = hidden_dim // 6
    e = (2.0 ** np.arange(n, dtype=np.float32)) * np.pi
    basis = np.zeros((3, 3 * n), dtype=np.float32)
    for i in range(3):
        basis[i, i * n:(i + 1) * n] = e
    return basis


def apply_point_basis(points: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` points -> ``(..., hidden_dim + 3)`` ``[sin, cos, xyz]``."""
    proj = points @ basis.to(points.dtype)
    return torch.cat([torch.sin(proj), torch.cos(proj), points], dim=-1)


def video_pos_embed(t: int, h: int, w: int, embed_dim: int) -> np.ndarray:
    """``(1, T*H*W, embed_dim)`` float32 table.

    Coordinates are normalised to [-1, 1] per axis (0 for a singleton axis)
    and mapped through ``embed_dim // 6`` frequencies ``2^linspace(0, 7)``
    with sin and cos.
    """
    def axis(n):
        a = np.arange(n, dtype=np.float32)
        return 2 * (a / (n - 1)) - 1 if n > 1 else np.zeros(1, dtype=np.float32)

    tt, hh, ww = np.meshgrid(axis(t), axis(h), axis(w), indexing="ij")
    pos = np.stack([tt, hh, ww], axis=-1)
    freq = (2.0 ** np.linspace(0.0, 7.0, embed_dim // 6)).astype(np.float32)
    ang = pos[..., None] * freq
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return emb.reshape(1, t * h * w, embed_dim).astype(np.float32)


def resize_pos_embed(pos: torch.Tensor, src_shape: tuple[int, int, int],
                     target_shape: tuple[int, int, int]) -> torch.Tensor:
    """Trilinearly resample a ``(1, T*H*W, C)`` table to a new (T, H, W)."""
    c = pos.shape[-1]
    grid = pos.reshape(1, *src_shape, c).permute(0, 4, 1, 2, 3)
    out = F.interpolate(grid.float(), size=tuple(target_shape),
                        mode="trilinear", align_corners=False)
    n = target_shape[0] * target_shape[1] * target_shape[2]
    return out.permute(0, 2, 3, 4, 1).reshape(1, n, c)
