"""Sliding-window long-video chunking with frame-0 anchoring.

Exact behavioural port of the reference's windowed inference (reference:
scripts/inference_with_video_mesh.py:132-256, identical logic in
inference_with_video_only.py:426-504). This is the framework's long-context
mechanism: windows of ``chunk`` frames with stride ``chunk - 1``, every window
after the first re-anchored on frame 0 (``[frame0] + frames[start+1:end]``),
outputs stitched by dropping each later window's anchor slot, with special
handling of the stride-adjusted tail window. Frame 0 of the merged result is
overwritten with the rest pose. The windows' outputs are stitched where they
are: numpy arrays on the host, torch tensors (the model's output on the
card) with the same indices.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["window_starts", "sliding_window_predict"]


def window_starts(total_t: int, chunk: int) -> list[int]:
    """Window start indices: stride ``chunk-1`` plus a tail window if needed."""
    slide = chunk - 1
    starts = list(range(0, total_t - chunk + 1, slide))
    if starts and (starts[-1] + chunk < total_t):
        starts.append(total_t - chunk)
    return starts


def sliding_window_predict(forward_fn: Callable, video: np.ndarray,
                           chunk: int, ref_pcd: np.ndarray):
    """Run ``forward_fn`` over sliding windows and stitch trajectories.

    Args:
      forward_fn: maps ``(T_w, H, W, 3)`` window frames -> ``(1, T_w, N, 3)``
        trajectories: numpy arrays, or torch tensors (on any device), which
        are then stitched as tensors where they lie.
      video: ``(T, H, W, 3)`` full video.
      chunk: window length (``training.frames``; 256 in the shipped scripts).
      ref_pcd: ``(1, N, 3)`` rest-pose points (frame-0 overwrite).

    Returns:
      ``(1, T, N, 3)`` stitched trajectories, of ``forward_fn``'s type.
    """
    total_t = video.shape[0]
    if total_t <= chunk:
        return _as_output(forward_fn(video))

    starts = window_starts(total_t, chunk)
    outs = []
    for i, s in enumerate(starts):
        e = s + chunk
        if i == 0:
            window = video[0:chunk]
        else:
            window = np.concatenate([video[0:1], video[s + 1:e]], axis=0)
        outs.append(_as_output(forward_fn(window)))

    if isinstance(outs[0], torch.Tensor):
        copy, cat = torch.clone, lambda parts: torch.cat(parts, dim=1)
        ref_pcd = torch.as_tensor(np.asarray(ref_pcd), dtype=outs[0].dtype,
                                  device=outs[0].device)
    else:
        copy, cat = np.copy, lambda parts: np.concatenate(parts, axis=1)

    n_out = len(outs)
    if n_out < 2:
        trajs = copy(outs[0])
        trajs[:, 0] = ref_pcd
        return trajs

    merged = []
    for i in range(n_out):
        if i == 0 and i != n_out - 2:
            first = copy(outs[0])
            first[:, 0] = ref_pcd
            merged.append(first)
        elif i < n_out - 2:
            merged.append(outs[i][:, 1:])
        elif i == n_out - 2:
            keep = max(starts[-1] - starts[-2], 0)
            if keep > 0 and n_out != 2:
                merged.append(outs[i][:, 1:1 + keep])
            elif keep > 0 and i == 0 and n_out == 2:
                first = copy(outs[0])
                first[:, 0] = ref_pcd
                merged.append(first[:, :1 + keep])
        elif i == n_out - 1:
            merged.append(outs[i][:, 1:])
    return cat(merged)


def _as_output(out):
    return out if isinstance(out, torch.Tensor) else np.asarray(out)
