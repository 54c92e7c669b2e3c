"""Debug visualisations (matplotlib, on the host).

The port's copy of ``motion324_tpu/utils/visualization.py`` (reference:
utils/visualization.py:21-307): input-data scatter panels, predicted (and
ground-truth) point motion as an animated GIF, and histograms of the
frame-to-frame displacement before and after smoothing. Inputs are numpy
arrays or CPU tensors. matplotlib and imageio, which the card's machine
lacks, are imported inside the functions.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["visualize_input_data", "visualize_point_cloud_motion",
           "plot_smoothing_comparison"]


def _scatter3d(ax, pts, colors=None, title=""):
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1,
               c=colors if colors is not None else "steelblue")
    ax.set_title(title)
    lim = np.abs(pts).max() + 1e-3
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)


def visualize_input_data(inputs: dict, save_path: str) -> str:
    """4-panel scatter of shape samples / query points / normals / colors
    (reference utils/visualization.py:21-86)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 4))
    shape = np.asarray(inputs["ref_shape_pcd"][0])
    pts = np.asarray(inputs["ref_pcd"][0])
    rgb = np.clip(np.asarray(inputs["ref_shape_rgbs"][0]), 0, 1)
    nrm = np.asarray(inputs["ref_shape_normals"][0])

    _scatter3d(fig.add_subplot(141, projection="3d"), shape,
               title=f"shape samples ({len(shape)})")
    _scatter3d(fig.add_subplot(142, projection="3d"), pts,
               title=f"query points ({len(pts)})")
    _scatter3d(fig.add_subplot(143, projection="3d"), shape, rgb,
               title="sampled albedo")
    _scatter3d(fig.add_subplot(144, projection="3d"), shape,
               np.clip(nrm * 0.5 + 0.5, 0, 1), title="normals")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path


def visualize_point_cloud_motion(trajs: np.ndarray, save_path: str,
                                 gt: np.ndarray | None = None,
                                 fps: int = 8, max_points: int = 2000) -> str:
    """Animated GIF of predicted (and optionally GT) point motion
    (reference utils/visualization.py:211-238)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import imageio.v3 as iio

    trajs = np.asarray(trajs)
    if trajs.ndim == 4:
        trajs = trajs[0]
    stride = max(1, trajs.shape[1] // max_points)
    frames = []
    for t in range(trajs.shape[0]):
        fig = plt.figure(figsize=(8, 4) if gt is not None else (4, 4))
        _scatter3d(fig.add_subplot(121 if gt is not None else 111,
                                   projection="3d"),
                   trajs[t, ::stride], title=f"pred t={t}")
        if gt is not None:
            g = np.asarray(gt)
            g = g[0] if g.ndim == 4 else g
            _scatter3d(fig.add_subplot(122, projection="3d"),
                       g[t, ::stride], title=f"gt t={t}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
        plt.close(fig)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    iio.imwrite(save_path, frames, duration=1000 // fps, loop=0)
    return save_path


def plot_smoothing_comparison(before: np.ndarray, after: np.ndarray,
                              threshold: float, save_path: str) -> str:
    """Histogram of frame-to-frame displacement magnitudes before/after
    smoothing (reference utils/visualization.py:240-307)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def mags(t):
        t = np.asarray(t)
        t = t[0] if t.ndim == 4 else t
        return np.linalg.norm(np.diff(t, axis=0), axis=-1).reshape(-1)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(mags(before), bins=80, alpha=0.5, label="before", log=True)
    ax.hist(mags(after), bins=80, alpha=0.5, label="after", log=True)
    ax.axvline(threshold, color="red", linestyle="--",
               label=f"threshold {threshold}")
    ax.set_xlabel("per-frame displacement")
    ax.legend()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return save_path
