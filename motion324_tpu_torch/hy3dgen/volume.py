"""Volume decoding: the ShapeVAE's occupancy logits over an (R+1)^3 grid.

- :func:`decode_volume`: the dense grid, scored in fixed chunks of points;
- :func:`decode_volume_hierarchical`: the full grid at ``R / coarse_factor``,
  upsampled on the host, then only the fine points near the coarse surface
  (a dilated band) scored again;
- :func:`decode_volume_flashvdm`: the hierarchical decode with the
  refinement points sorted into spatial cells and each chunk scored against
  its top-k latents only (:meth:`ShapeVAE.query_topk`).

Points are generated on the device from flat grid indices, chunk by chunk,
and the logits stay on the device in f32 until the whole grid is read back
once. (The JAX package reads its grid back in f16 to halve a slow host
link; on the card the f32 copy is small beside the decode, so the port
keeps the logits exact.) Refinement chunk counts are bucketed as in the JAX
package (powers of two up to 64 chunks, then multiples of 64), so a mesh
makes the same number of query calls, and attention launches, there and
here. Every decoder returns ``(grid (R+1, R+1, R+1) float32, chunks)``,
``chunks`` being the number of ``query_fn`` calls it made.

``query_fn(points (1, N, 3) f32 tensor, latents) -> (1, N)`` scores points.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_grid", "decode_volume", "decode_volume_hierarchical",
           "decode_volume_flashvdm", "refine_chunk_count"]


def make_grid(resolution: int, box_v: float = 1.01) -> np.ndarray:
    """((R+1)^3, 3) query points over ``[-box_v, box_v]^3`` (x-major)."""
    ax = np.linspace(-box_v, box_v, resolution + 1, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def _flat_to_points(flat_idx: torch.Tensor, r: int, box_v: float):
    """int flat grid indices -> (..., 3) f32 coordinates, on their device."""
    x = flat_idx // (r * r)
    y = (flat_idx // r) % r
    z = flat_idx % r
    step = 2.0 * box_v / (r - 1)
    return torch.stack([x, y, z], dim=-1).float() * step - box_v


def _device(latents) -> torch.device:
    return latents.device if isinstance(latents, torch.Tensor) else torch.device("cpu")


def _score(query_fn, latents, flat: torch.Tensor, r: int, box_v: float,
           chunk: int) -> torch.Tensor:
    """Logits (f32, on the device) of the points at ``flat`` indices, whose
    length is a multiple of ``chunk``, one ``query_fn`` call per chunk."""
    out = torch.empty(flat.numel(), dtype=torch.float32, device=flat.device)
    for i in range(0, flat.numel(), chunk):
        pts = _flat_to_points(flat[i:i + chunk], r, box_v)
        out[i:i + chunk] = query_fn(pts[None], latents)[0]
    return out


def decode_volume(query_fn, processed_latents, resolution: int = 384,
                  box_v: float = 1.01, chunk: int = 8192):
    """Dense grid decode -> ``((R+1,)*3 float32 logits, chunks)``."""
    r = resolution + 1
    n = r * r * r
    n_chunks = -(-n // chunk)
    dev = _device(processed_latents)
    # the last chunk's padding repeats the last point
    flat = torch.arange(n_chunks * chunk, device=dev).clamp_(max=n - 1)
    logits = _score(query_fn, processed_latents, flat, r, float(box_v), chunk)
    return logits[:n].cpu().numpy().reshape(r, r, r), n_chunks


def _dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Cross-structured (6-neighbour) binary dilation by shifted ORs."""
    m = mask
    for _ in range(iterations):
        out = m.copy()
        out[1:] |= m[:-1]
        out[:-1] |= m[1:]
        out[:, 1:] |= m[:, :-1]
        out[:, :-1] |= m[:, 1:]
        out[:, :, 1:] |= m[:, :, :-1]
        out[:, :, :-1] |= m[:, :, 1:]
        m = out
    return m


def _shell_indices_numpy(volume: np.ndarray, band: float, iters: int,
                         sort_grid: int) -> np.ndarray:
    """Plain version of :func:`motion324_tpu_torch.native.shell_indices`:
    int32 flat indices of the dilated ``|v| < band`` shell, stable-sorted by
    ``sort_grid``^3 spatial cell (``sort_grid=1``: argwhere order)."""
    r = volume.shape[0]
    mask = _dilate(np.abs(volume) < band, iters)
    idx = np.argwhere(mask).astype(np.int32)
    if sort_grid > 1 and len(idx):
        cell = idx * sort_grid // r
        key = (cell[:, 0] * sort_grid + cell[:, 1]) * sort_grid + cell[:, 2]
        idx = idx[np.argsort(key, kind="stable")]
    return ((idx[:, 0].astype(np.int64) * r + idx[:, 1]) * r
            + idx[:, 2]).astype(np.int32)


def _lerp_last(a: np.ndarray, f: int) -> np.ndarray:
    """Upsample the last axis by integer factor ``f``, edge-aligned linear:
    n points -> (n-1) f + 1."""
    lo, hi = a[..., :-1], a[..., 1:]
    w = np.arange(f, dtype=np.float32) / f
    seg = lo[..., None] * (1.0 - w) + hi[..., None] * w
    out = seg.reshape(a.shape[:-1] + ((a.shape[-1] - 1) * f,))
    return np.concatenate([out, a[..., -1:]], axis=-1)


def _trilinear_numpy(coarse: np.ndarray, f: int) -> np.ndarray:
    """Plain version of :func:`motion324_tpu_torch.native.trilinear_upsample`:
    three last-axis lerps, cycling the axes."""
    out = np.asarray(coarse, np.float32)
    for _ in range(3):
        out = _lerp_last(np.ascontiguousarray(np.transpose(out, (1, 2, 0))), f)
    return np.ascontiguousarray(out, np.float32)


def _host_trilinear(coarse: np.ndarray, r: int) -> np.ndarray:
    """(c, c, c) -> (r, r, r) node-aligned trilinear upsample on the host:
    the native helper where (r-1) is a multiple of (c-1), else scipy's
    order-1 zoom."""
    c = coarse.shape[0]
    if (r - 1) % (c - 1) == 0:
        from motion324_tpu_torch import native
        return native.trilinear_upsample(coarse, (r - 1) // (c - 1))
    from scipy.ndimage import zoom
    out = zoom(np.asarray(coarse, np.float32), r / c, order=1,
               mode="nearest", grid_mode=True)
    if out.shape != (r, r, r):   # zoom may be a voxel off on the exact size
        out = out[:r, :r, :r]
        out = np.pad(out, [(0, r - s) for s in out.shape], mode="edge")
    return np.ascontiguousarray(out, np.float32)


def refine_chunk_count(n_points: int, chunk: int) -> int:
    """Chunks scored for ``n_points`` refinement points: the JAX package's
    buckets, powers of two up to 64 chunks, then multiples of 64."""
    n = max(-(-n_points // chunk), 1)
    if n <= 64:
        return 1 << (n - 1).bit_length()
    return -(-n // 64) * 64


def _refine(query_fn, latents, fine: np.ndarray, flat: np.ndarray, r: int,
            box_v: float, chunk: int) -> int:
    """Score the points at ``flat`` into ``fine`` in place; returns the
    chunk count."""
    n_chunks = refine_chunk_count(len(flat), chunk)
    idx = torch.zeros(n_chunks * chunk, dtype=torch.int64,
                      device=_device(latents))
    idx[:len(flat)] = torch.from_numpy(flat.astype(np.int64)).to(idx.device)
    logits = _score(query_fn, latents, idx, r, box_v, chunk)
    fine.reshape(-1)[flat] = logits[:len(flat)].cpu().numpy()
    return n_chunks


def _coarse_to_fine(query_fn, refine_fn, latents, resolution, box_v, chunk,
                    coarse_factor, band, sort_grid):
    from motion324_tpu_torch import native
    coarse, n_coarse = decode_volume(query_fn, latents,
                                     max(resolution // coarse_factor, 16),
                                     box_v, chunk)
    r = resolution + 1
    fine = _host_trilinear(coarse, r)
    # the band is measured on the upsampled field, so the true surface lies
    # within about half a coarse cell of it: dilate by that many fine voxels
    flat = native.shell_indices(fine, band, max(coarse_factor // 2, 1),
                                sort_grid)
    if len(flat) == 0:
        return fine, n_coarse
    return fine, n_coarse + _refine(refine_fn, latents, fine, flat, r,
                                    float(box_v), chunk)


def decode_volume_hierarchical(query_fn, processed_latents,
                               resolution: int = 384, box_v: float = 1.01,
                               chunk: int = 8192, coarse_factor: int = 4,
                               band: float = 4.0):
    """Coarse-to-fine decode -> ``(grid, chunks)``. Points whose upsampled
    coarse logit lies within ``band`` of 0 (dilated) are scored on the fine
    grid; the rest keep the upsampled value. Near the surface, which is all
    marching cubes reads, this matches :func:`decode_volume`."""
    return _coarse_to_fine(query_fn, query_fn, processed_latents, resolution,
                           box_v, chunk, coarse_factor, band, 1)


def decode_volume_flashvdm(vae, processed_latents, resolution: int = 384,
                           box_v: float = 1.01, chunk: int = 8192,
                           coarse_factor: int = 4, band: float = 4.0,
                           topk: int = 64, sort_grid: int = 8):
    """Hierarchical decode whose refinement points are sorted into
    ``sort_grid``^3 spatial cells, each chunk scored by
    :meth:`ShapeVAE.query_topk` against the ``topk`` latents its probes rank
    highest -> ``(grid, chunks)``. With ``topk`` at least the latent count
    this is :func:`decode_volume_hierarchical`."""
    return _coarse_to_fine(
        vae.query, lambda pts, lat: vae.query_topk(pts, lat, topk),
        processed_latents, resolution, box_v, chunk, coarse_factor, band,
        sort_grid)
