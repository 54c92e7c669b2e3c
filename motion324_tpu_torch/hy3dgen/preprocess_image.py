"""Shape-gen image preprocessing: alpha-aware recenter + resize.

The alpha bounding box of the subject is rescaled so its longest side fills
``1 - border_ratio`` of a square canvas, centred, composited over white, then
resized to the conditioning resolution (518^2 for the DINO-giant
conditioner). The recenter changes shape-gen conditioning materially: a
plain resize leaves the subject at a scale and offset the diffusion model
never saw. cv2 is imported inside the functions, so that the module loads
where cv2 is missing (a caller there passes ``recenter=False``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["recenter_image", "prepare_condition_image",
           "prepare_condition_images_mv"]


def recenter_image(image: np.ndarray, border_ratio: float = 0.2):
    """(H, W, 3|4) float [0,1] or uint8 -> (S, S, 3) float [0,1], (S, S) mask.

    Square canvas of side max(H, W); subject (alpha bbox) scaled to
    ``(1-border_ratio)`` of the canvas and centred; RGB composited over white
    (integer bbox, INTER_AREA resize).
    """
    import cv2
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.shape[-1] == 4:
        mask = img[..., 3]
    else:
        mask = np.full_like(img[..., 0], 255)
        img = np.concatenate([img, mask[..., None]], axis=-1)

    h_img, w_img, c = img.shape
    size = max(h_img, w_img)
    result = np.zeros((size, size, c), dtype=np.uint8)

    coords = np.nonzero(mask)
    if len(coords[0]) == 0:
        raise ValueError("input image is empty (no alpha coverage)")
    x_min, x_max = coords[0].min(), coords[0].max()
    y_min, y_max = coords[1].min(), coords[1].max()
    h = x_max - x_min
    w = y_max - y_min
    if h == 0 or w == 0:
        raise ValueError("input image is empty (degenerate alpha bbox)")
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    h2, w2 = int(h * scale), int(w * scale)
    x2, y2 = (size - h2) // 2, (size - w2) // 2
    result[x2:x2 + h2, y2:y2 + w2] = cv2.resize(
        img[x_min:x_max, y_min:y_max], (w2, h2),
        interpolation=cv2.INTER_AREA)

    alpha = result[..., 3:].astype(np.float32) / 255
    rgb = result[..., :3].astype(np.float32) / 255
    out = rgb * alpha + (1 - alpha)  # white background
    return out.astype(np.float32), alpha[..., 0]


def prepare_condition_image(image: np.ndarray, size: int = 518,
                            border_ratio: float = 0.15):
    """Full conditioning prep: recenter + cubic resize to ``size``^2."""
    import cv2
    out, mask = recenter_image(image, border_ratio)
    out = cv2.resize(out, (size, size), interpolation=cv2.INTER_CUBIC)
    mask = cv2.resize(mask, (size, size), interpolation=cv2.INTER_NEAREST)
    return np.clip(out, 0, 1), mask


def prepare_condition_images_mv(image_dict: dict, size: int = 518,
                                border_ratio: float = 0.15):
    """Multiview conditioning prep.

    ``image_dict`` maps view tags (subset of front/left/back/right) to images;
    each view is recentered + resized like the single-view path, then views
    are SORTED by canonical slot index (front=0, left=1, back=2, right=3).
    Returns ``(images (V, S, S, 3), masks (V, S, S), view_idxs (V,) int)``.
    """
    from motion324_tpu_torch.hy3dgen.conditioner import VIEW_SLOTS
    entries = []
    for tag, img in image_dict.items():
        if tag not in VIEW_SLOTS:
            raise ValueError(f"unknown view tag {tag!r}; expected one of "
                             f"{sorted(VIEW_SLOTS)}")
        out, mask = prepare_condition_image(img, size, border_ratio)
        entries.append((VIEW_SLOTS[tag], out, mask))
    entries.sort(key=lambda e: e[0])
    idxs = np.array([e[0] for e in entries], np.int32)
    images = np.stack([e[1] for e in entries])
    masks = np.stack([e[2] for e in entries])
    return images, masks, idxs
