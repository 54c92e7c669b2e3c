"""Sliding-window long-video chunking with frame-0 anchoring.

Exact behavioural port of the reference's windowed inference (reference:
scripts/inference_with_video_mesh.py:132-256, identical logic in
inference_with_video_only.py:426-504). This is the framework's long-context
mechanism: windows of ``chunk`` frames with stride ``chunk - 1``, every window
after the first re-anchored on frame 0 (``[frame0] + frames[start+1:end]``),
outputs stitched by dropping each later window's anchor slot, with special
handling of the stride-adjusted tail window. Frame 0 of the merged result is
overwritten with the rest pose.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["window_starts", "sliding_window_predict"]


def window_starts(total_t: int, chunk: int) -> list[int]:
    """Window start indices: stride ``chunk-1`` plus a tail window if needed."""
    slide = chunk - 1
    starts = list(range(0, total_t - chunk + 1, slide))
    if starts and (starts[-1] + chunk < total_t):
        starts.append(total_t - chunk)
    return starts


def sliding_window_predict(forward_fn: Callable[[np.ndarray], np.ndarray],
                           video: np.ndarray, chunk: int,
                           ref_pcd: np.ndarray) -> np.ndarray:
    """Run ``forward_fn`` over sliding windows and stitch trajectories.

    Args:
      forward_fn: maps ``(T_w, H, W, 3)`` window frames -> ``(1, T_w, N, 3)``.
      video: ``(T, H, W, 3)`` full video.
      chunk: window length (``training.frames``; 256 in the shipped scripts).
      ref_pcd: ``(1, N, 3)`` rest-pose points (frame-0 overwrite).

    Returns:
      ``(1, T, N, 3)`` stitched trajectories.
    """
    total_t = video.shape[0]
    if total_t <= chunk:
        return np.asarray(forward_fn(video))

    starts = window_starts(total_t, chunk)
    outs = []
    for i, s in enumerate(starts):
        e = s + chunk
        if i == 0:
            window = video[0:chunk]
        else:
            window = np.concatenate([video[0:1], video[s + 1:e]], axis=0)
        outs.append(np.asarray(forward_fn(window)))

    n_out = len(outs)
    if n_out < 2:
        trajs = outs[0].copy()
        trajs[:, 0] = ref_pcd
        return trajs

    merged = []
    for i in range(n_out):
        if i == 0 and i != n_out - 2:
            first = outs[0].copy()
            first[:, 0] = ref_pcd
            merged.append(first)
        elif i < n_out - 2:
            merged.append(outs[i][:, 1:])
        elif i == n_out - 2:
            keep = max(starts[-1] - starts[-2], 0)
            if keep > 0 and n_out != 2:
                merged.append(outs[i][:, 1:1 + keep])
            elif keep > 0 and i == 0 and n_out == 2:
                first = outs[0].copy()
                first[:, 0] = ref_pcd
                merged.append(first[:, :1 + keep])
        elif i == n_out - 1:
            merged.append(outs[i][:, 1:])
    return np.concatenate(merged, axis=1)
