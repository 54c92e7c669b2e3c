"""Delight (shadow/highlight removal) for reference images.

The port's copy of the weight-free part of ``motion324_tpu/hy3dgen/
delight.py`` (numpy and scipy on the host): the per-channel colour
recorrection that the reference always applies after its InstructPix2Pix
delighter (reference: scripts/hy3dgen/texgen/utils/dehighlight_utils.py:
38-66), re-matching the edited image's per-channel mean/std to the
original's over the foreground, and :func:`delight_image`. The diffusion
delighter itself (``DelightDiffusion``) is not ported yet; an ``editor``
callable takes its place.

Without diffusion weights, :func:`delight_image` applies a deterministic
de-shading approximation (divide out low-frequency luminance) followed by the
same recorrection, so downstream texture generation sees flattened lighting.
"""

from __future__ import annotations

import numpy as np

__all__ = ["color_recorrection", "delight_image"]


def color_recorrection(edited: np.ndarray, original: np.ndarray,
                       mask: np.ndarray | None = None) -> np.ndarray:
    """Per-channel mean/std re-match of ``edited`` against ``original``
    (reference dehighlight_utils.py:38-66)."""
    edited = np.asarray(edited, np.float32)
    original = np.asarray(original, np.float32)
    sel = (slice(None),) if mask is None else (mask > 0.5,)
    out = edited.copy()
    for c in range(3):
        e = edited[..., c][sel] if mask is not None else edited[..., c]
        o = original[..., c][sel] if mask is not None else original[..., c]
        es, os_ = float(e.std()) + 1e-6, float(o.std()) + 1e-6
        out[..., c] = (edited[..., c] - float(e.mean())) / es * os_ \
            + float(o.mean())
    return np.clip(out, 0.0, 1.0)


def delight_image(image: np.ndarray, mask: np.ndarray | None = None,
                  editor=None, blur_sigma: float = 12.0) -> np.ndarray:
    """Remove baked-in lighting from an image.

    ``editor``: optional callable (image -> image) — the diffusion-based
    delighter. Fallback: divide out the gaussian-smoothed luminance field
    (flattens soft shading/shadows), then recorrect colors.
    """
    from scipy.ndimage import gaussian_filter
    image = np.asarray(image, np.float32)
    if editor is not None:
        edited = editor(image)
    else:
        lum = image @ np.array([0.299, 0.587, 0.114], np.float32)
        smooth = gaussian_filter(lum, blur_sigma)
        gain = np.clip(smooth.mean() / np.maximum(smooth, 1e-3), 0.5, 2.0)
        edited = np.clip(image * gain[..., None], 0.0, 1.0)
    return color_recorrection(edited, image, mask)
