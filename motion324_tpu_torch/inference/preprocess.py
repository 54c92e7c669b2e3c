"""Video preprocessing: background removal and a global, centred crop.

Counterpart of ``motion324_tpu/inference/preprocess.py`` (the reference's
``rmbg_for_black_bg.py``): per-frame foreground masks (U2Net or ISNet with
weights, else the border-statistics fallback), a bounding box over all
frames so that the subject does not jitter across crops, a square crop
centred on it, and a resize to ``size``^2 on black. The area resize is the
port's cv2-free INTER_AREA (:func:`motion324_tpu_torch.utils.image.
resize_area`), so no cv2 is needed.
"""

from __future__ import annotations

import numpy as np

from motion324_tpu_torch.inference.segmentation import segment_frames
from motion324_tpu_torch.utils.image import resize_area

__all__ = ["global_bbox", "crop_and_center", "preprocess_video_frames"]


def global_bbox(masks: np.ndarray, margin: float = 0.05):
    """Union bounding box ``(y0, y1, x0, x1)`` of ``(T, H, W)`` masks,
    widened by ``margin`` of its size on each side; the whole frame when no
    pixel is set."""
    any_mask = masks.max(axis=0) > 0.5
    h, w = any_mask.shape
    if not any_mask.any():
        return 0, h, 0, w
    ys, xs = np.where(any_mask)
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    my = int((y1 - y0) * margin)
    mx = int((x1 - x0) * margin)
    return max(0, y0 - my), min(h, y1 + my), max(0, x0 - mx), min(w, x1 + mx)


def crop_and_center(frame: np.ndarray, bbox, size: int = 512) -> np.ndarray:
    """Crop ``(H, W, C)`` to ``bbox``, pad to a square on black, INTER_AREA
    resize to ``size``^2. Float input stays float32; integer input is
    rounded back to its dtype."""
    y0, y1, x0, x1 = bbox
    crop = frame[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    side = max(h, w)
    pad_y, pad_x = (side - h) // 2, (side - w) // 2
    sq = np.zeros((side, side, crop.shape[2]), crop.dtype)
    sq[pad_y:pad_y + h, pad_x:pad_x + w] = crop
    out = resize_area(sq, (size, size)).numpy()
    if np.issubdtype(crop.dtype, np.integer):
        info = np.iinfo(crop.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(crop.dtype)
    return out


def preprocess_video_frames(frames: np.ndarray, params=None,
                            alpha_threshold: float = 0.8, size: int = 512,
                            model=None, device=None):
    """``(T, H, W, 3)`` frames in [0, 1] -> ``(masked size^2 frames, masks,
    bbox)``. The background is blacked out, as the model was trained on
    black-background renders. With ``params`` (a U2Net or, with ``model``
    an :class:`~motion324_tpu_torch.inference.segmentation.ISNet`, an
    ISNet state dict or path) the network segments at ``alpha_threshold``
    on ``device``; without, the border-statistics fallback at 0.5."""
    masks = segment_frames(frames, params=params, model=model,
                           threshold=alpha_threshold if params is not None
                           else 0.5, device=device)
    bbox = global_bbox(masks)
    out_frames, out_masks = [], []
    for t in range(len(frames)):
        fg = frames[t] * masks[t][..., None]
        out_frames.append(crop_and_center(fg.astype(np.float32), bbox, size))
        m = crop_and_center(masks[t][..., None].astype(np.float32), bbox, size)
        out_masks.append(m[..., 0])
    return np.stack(out_frames), np.stack(out_masks), bbox
