"""Surface-point tracking on deforming mesh sequences (host numpy); a copy of
``motion324_tpu/data/tracking.py``.

Reproduces the reference's barycentric tracking (reference:
dataset/dataset_utils.py:44-136 ``track_with_normal_rgb``): sample points on
the frame-0 surface, fix their (face, barycentric) coordinates, then
re-evaluate positions and interpolated vertex normals at every frame, and
sample a fixed RGB per point from the texture atlas via interpolated UVs.

The per-frame Python loop of the reference is replaced with batched einsums
over the full (T, ...) sequence.
"""

from __future__ import annotations

import numpy as np

from motion324_tpu_torch.io.mesh import TriMesh, sample_surface

__all__ = ["track_points", "sample_texture_colors", "sequence_vertex_normals"]


def sample_texture_colors(uvs: np.ndarray, texture: np.ndarray) -> np.ndarray:
    """UV -> texel colors with the dataset's indexing convention
    (reference dataset/dataset_utils.py:19-41: ``x = u*(W-1)``,
    ``y = (1-v)*(H-1)``, clipped)."""
    h, w = texture.shape[:2]
    x = np.clip((uvs[:, 0] * (w - 1)).astype(np.int64), 0, w - 1)
    y = np.clip(((1 - uvs[:, 1]) * (h - 1)).astype(np.int64), 0, h - 1)
    return texture[y, x]


def sequence_vertex_normals(vertex_frames: np.ndarray,
                            faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for every frame: (T, V, 3)."""
    t, v, _ = vertex_frames.shape
    tri = vertex_frames[:, faces]  # (T, F, 3, 3)
    fn = np.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    vn = np.zeros((t, v, 3), np.float64)
    for c in range(3):
        np.add.at(vn, (slice(None), faces[:, c]), fn)
    vn /= (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12)
    return vn.astype(np.float32)


def track_points(vertex_frames: np.ndarray, faces: np.ndarray,
                 num_samples: int, face_uvs: np.ndarray | None = None,
                 texture: np.ndarray | None = None, seed: int = 0):
    """Sample + track ``num_samples`` surface points over a (T, V, 3) sequence.

    Returns ``(points (T,S,3), normals (T,S,3), rgbs (T,S,3), face_idx (S,))``.
    RGBs are fixed over time (sampled once on frame 0's UVs); normals are
    barycentric interpolations of per-frame vertex normals, renormalised.
    """
    t_frames = vertex_frames.shape[0]
    mesh0 = TriMesh(vertices=vertex_frames[0].astype(np.float32),
                    faces=faces.astype(np.int64))
    _, face_idx, bary = sample_surface(mesh0, num_samples, seed=seed)

    corner_idx = faces[face_idx]  # (S, 3) vertex ids
    # positions for all frames at once: (T, S, 3, 3) corners x (S, 3) bary
    corners = vertex_frames[:, corner_idx]  # (T, S, 3, 3)
    points = np.einsum("sk,tskd->tsd", bary, corners).astype(np.float32)

    vn = sequence_vertex_normals(vertex_frames.astype(np.float64), faces)
    corner_normals = vn[:, corner_idx]  # (T, S, 3, 3)
    normals = np.einsum("sk,tskd->tsd", bary, corner_normals)
    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = (normals / np.where(norms == 0, 1.0, norms)).astype(np.float32)

    if face_uvs is not None and texture is not None:
        uvs = np.einsum("sk,skd->sd", bary, face_uvs[face_idx])
        rgbs0 = sample_texture_colors(uvs, texture).astype(np.float32)
        if rgbs0.max() > 1.5:  # uint8-range atlas
            rgbs0 = rgbs0 / 255.0
    else:
        rgbs0 = np.full((num_samples, 3), 0.5, np.float32)
    rgbs = np.broadcast_to(rgbs0[None], (t_frames, num_samples, 3)).copy()

    return points, normals, rgbs, face_idx
