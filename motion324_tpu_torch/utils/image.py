"""The image operations of the texture path, without cv2.

The JAX package takes these from OpenCV; the card's machine has no cv2, so
the port computes them in PyTorch (on the tensor's device) with OpenCV's
semantics:

- :func:`resize_area`: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  as two weight matrices: fractional-area weights when shrinking, OpenCV's
  area-mode linear weights when growing;
- :func:`erode` / :func:`dilate`: a square structuring element with
  OpenCV's default border, which never erodes and never dilates;
- :func:`canny`: ``cv2.Canny(img, low, high)``: 3x3 Sobel with a replicated
  border, the L1 magnitude, OpenCV's fixed-point 22.5-degree sectors for
  the non-maximum suppression, and 8-connected hysteresis (labelled with
  scipy on the host).

The Navier-Stokes hole fill (``cv2.inpaint(..., INPAINT_NS)``) is native
code: :func:`motion324_tpu_torch.native.inpaint_ns`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_area", "erode", "dilate", "canny"]


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """``(dsize, ssize)`` float32 weights of OpenCV's INTER_AREA along one
    axis."""
    w = np.zeros((dsize, ssize), np.float64)
    inv = dsize / ssize
    scale = 1.0 / inv          # as OpenCV forms it: not always ssize / dsize
    if ssize >= dsize:
        # shrinking: each output cell averages the source interval it covers
        # (computeResizeAreaTab)
        for dx in range(dsize):
            fsx1 = dx * scale
            fsx2 = fsx1 + scale
            cell = min(scale, ssize - fsx1)
            sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
            sx2 = min(sx2, ssize - 1)
            sx1 = min(sx1, sx2)
            if sx1 - fsx1 > 1e-3:
                w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
            for sx in range(sx1, sx2):
                w[dx, sx] = np.float32(1.0 / cell)
            if fsx2 - sx2 > 1e-3:
                w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    else:
        # growing: linear weights with OpenCV's area-mode phase, the phase
        # rounded to float32 as OpenCV rounds it
        for dx in range(dsize):
            sx = math.floor(dx * scale)
            fx = np.float32((dx + 1) - (sx + 1) * inv)
            fx = np.float32(0) if fx <= 0 else fx - np.float32(math.floor(fx))
            if sx < 0:
                sx, fx = 0, np.float32(0)
            if sx >= ssize - 1:
                sx, fx = ssize - 1, np.float32(0)
            w[dx, sx] += np.float32(1) - fx
            if fx:
                w[dx, sx + 1] += fx
    return w.astype(np.float32)


def resize_area(img, size: tuple[int, int]) -> torch.Tensor:
    """``img`` (H, W[, C]) float -> (h, w[, C]) float32 for ``size = (w,
    h)``, OpenCV's INTER_AREA; the same size returns a copy."""
    x = torch.as_tensor(img).float()
    w_out, h_out = size
    h, w = x.shape[:2]
    if (h, w) == (h_out, w_out):
        return x.clone()
    wy = torch.from_numpy(_area_weights(h, h_out)).to(x.device)
    wx = torch.from_numpy(_area_weights(w, w_out)).to(x.device)
    flat = x.reshape(h, w, -1)
    out = torch.einsum("yh,hwc->ywc", wy, flat)
    out = torch.einsum("xw,ywc->yxc", wx, out)
    return out.reshape(h_out, w_out, *x.shape[2:])


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max over a 2-D tensor, the outside counting as -inf."""
    return F.max_pool2d(x[None, None].float(), k, stride=1,
                        padding=k // 2)[0, 0]


def dilate(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.dilate(img, np.ones((k, k)))`` for odd ``k``, in img's dtype."""
    return _pool(img, k).to(img.dtype)


def erode(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.erode(img, np.ones((k, k)))`` for odd ``k``, in img's dtype:
    the border counts as the largest value, so it never erodes."""
    return (-_pool(-img.float(), k)).to(img.dtype)


_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def canny(img: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``cv2.Canny(img, low, high)`` of an (H, W) uint8 image: uint8 edges,
    255 on an edge, on img's device."""
    x = img.float()[None, None]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")[0, 0]
    c = xp[1:-1]
    dx = ((xp[:-2, 2:] - xp[:-2, :-2]) + 2 * (c[:, 2:] - c[:, :-2])
          + (xp[2:, 2:] - xp[2:, :-2])).to(torch.int32)
    c = xp[:, 1:-1]
    dy = ((xp[2:, :-2] - xp[:-2, :-2]) + 2 * (c[2:] - c[:-2])
          + (xp[2:, 2:] - xp[:-2, 2:])).to(torch.int32)
    mag = dx.abs() + dy.abs()
    # neighbours' magnitudes, 0 outside the image
    mp = F.pad(mag, (1, 1, 1, 1))
    at = lambda oy, ox: mp[1 + oy:mp.shape[0] - 1 + oy, 1 + ox:mp.shape[1] - 1 + ox]
    ax = dx.abs().long()
    ay = dy.abs().long() << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    horiz = ay < tg22
    vert = ay > tg67
    s = torch.where((dx ^ dy) < 0, -1, 1)
    # the diagonal neighbours: (row - 1, col - s) and (row + 1, col + s)
    diag = torch.where(s < 0, (mag > at(-1, 1)) & (mag > at(1, -1)),
                       (mag > at(-1, -1)) & (mag > at(1, 1)))
    peak = torch.where(horiz, (mag > at(0, -1)) & (mag >= at(0, 1)),
                       torch.where(vert, (mag > at(-1, 0)) & (mag >= at(1, 0)),
                                   diag))
    cand = peak & (mag > int(math.floor(low)))
    strong = cand & (mag > int(math.floor(high)))
    from scipy import ndimage
    labels, n = ndimage.label(cand.cpu().numpy(), structure=np.ones((3, 3)))
    keep = np.zeros(n + 1, bool)
    keep[np.unique(labels[strong.cpu().numpy()])] = True
    keep[0] = False
    edges = torch.from_numpy(keep[labels]).to(img.device)
    return edges.to(torch.uint8) * 255
