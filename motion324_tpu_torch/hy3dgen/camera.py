"""Camera math for multi-view mesh rendering (host numpy constants).

The port's own copy of ``motion324_tpu/hy3dgen/camera.py``.

Matches the reference's conventions (reference:
scripts/hy3dgen/texgen/differentiable_renderer/camera_utils.py:37-106):
z-up world, azimuth offset by +90 deg, elevation negated; right-handed
look-at with ``-lookat`` as camera z; OpenGL-style orthographic and
perspective projections.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["view_matrix", "orthographic", "perspective", "transform_points",
           "DEFAULT_VIEWS"]

# the six baking views: (azimuth, elevation, weight)
# (reference scripts/hy3dgen/texgen/pipelines.py:40-42)
DEFAULT_VIEWS = [
    (0, 0, 1.0), (90, 0, 0.1), (180, 0, 0.5), (270, 0, 0.1),
    (0, 90, 0.05), (180, -90, 0.05),
]


def view_matrix(elev: float, azim: float, camera_distance: float = 1.45,
                center=None) -> np.ndarray:
    """World-to-camera matrix for an (elev, azim) orbit camera."""
    elev = -elev
    azim = azim + 90
    er, ar = math.radians(elev), math.radians(azim)
    eye = np.array([camera_distance * math.cos(er) * math.cos(ar),
                    camera_distance * math.cos(er) * math.sin(ar),
                    camera_distance * math.sin(er)])
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    up = up / np.linalg.norm(up)

    rot = np.stack([right, up, -fwd], axis=0)  # rows of w2c
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c.astype(np.float32)


def orthographic(left=-1.0, right=1.0, bottom=-1.0, top=1.0,
                 near=0.0, far=2.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2 / (right - left)
    m[1, 1] = 2 / (top - bottom)
    m[2, 2] = -2 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    return m


def perspective(fovy_deg: float, aspect_wh: float = 1.0, near: float = 0.1,
                far: float = 100.0) -> np.ndarray:
    t = math.tan(math.radians(fovy_deg) / 2.0)
    return np.array([
        [1.0 / (t * aspect_wh), 0, 0, 0],
        [0, 1.0 / t, 0, 0],
        [0, 0, -(far + near) / (far - near), -2.0 * far * near / (far - near)],
        [0, 0, -1.0, 0],
    ], dtype=np.float32)


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    """(4,4) @ (N,3|4) -> (N,4) homogeneous transform (row-vector convention)."""
    if points.shape[-1] == 3:
        points = np.concatenate(
            [points, np.ones((*points.shape[:-1], 1), points.dtype)], axis=-1)
    return points @ matrix.T
