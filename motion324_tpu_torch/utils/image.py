"""The image operations of the texture path, without cv2.

The JAX package takes these from OpenCV; the card's machine has no cv2, so
the port computes them in PyTorch (on the tensor's device) with OpenCV's
semantics:

- :func:`resize_area`: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  as two weight matrices: fractional-area weights when the image shrinks
  along both axes, else OpenCV's area-mode linear weights along both;
- :func:`resize_cubic` / :func:`resize_lanczos4`: ``cv2.resize`` with
  INTER_CUBIC (a = -0.75, 4 taps) / INTER_LANCZOS4 (8 taps, normalised), the
  taps at ``(d + 0.5) * scale - 0.5`` and the border replicated, as weight
  matrices;
- :func:`gaussian_blur`: ``cv2.GaussianBlur(img, (0, 0), sigma)`` of a
  float image: OpenCV's kernel of ``round(8 sigma + 1) | 1`` taps, border
  REFLECT_101;
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

__all__ = ["resize_area", "resize_cubic", "resize_lanczos4", "gaussian_blur",
           "erode", "dilate", "canny"]


def _area_weights(ssize: int, dsize: int, shrink: bool) -> np.ndarray:
    """``(dsize, ssize)`` float32 weights of OpenCV's INTER_AREA along one
    axis: fractional-area averaging where the image shrinks along both axes
    (``shrink``), else OpenCV's area-mode linear weights, along either
    axis."""
    w = np.zeros((dsize, ssize), np.float64)
    inv = dsize / ssize
    scale = 1.0 / inv          # as OpenCV forms it: not always ssize / dsize
    if shrink:
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
        # growing along some axis: linear weights with OpenCV's area-mode
        # phase, the phase rounded to float32 as OpenCV rounds it
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


def _separable(x: torch.Tensor, wy: np.ndarray, wx: np.ndarray) -> torch.Tensor:
    """``wy @ x @ wx.T`` over the first two axes of ``x`` (H, W[, C])."""
    h_out, w_out = wy.shape[0], wx.shape[0]
    wy = torch.from_numpy(wy).to(x.device)
    wx = torch.from_numpy(wx).to(x.device)
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    out = torch.einsum("yh,hwc->ywc", wy, flat)
    out = torch.einsum("xw,ywc->yxc", wx, out)
    return out.reshape(h_out, w_out, *x.shape[2:])


def resize_area(img, size: tuple[int, int]) -> torch.Tensor:
    """``img`` (H, W[, C]) float -> (h, w[, C]) float32 for ``size = (w,
    h)``, OpenCV's INTER_AREA; the same size returns a copy."""
    x = torch.as_tensor(img).float()
    w_out, h_out = size
    h, w = x.shape[:2]
    if (h, w) == (h_out, w_out):
        return x.clone()
    shrink = h >= h_out and w >= w_out
    return _separable(x, _area_weights(h, h_out, shrink),
                      _area_weights(w, w_out, shrink))


def _cubic_coeffs(fx: np.float32) -> list:
    """OpenCV's ``interpolateCubic`` (a = -0.75), in float32."""
    a, one = np.float32(-0.75), np.float32(1)
    x1 = fx + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * fx - (a + np.float32(3))) * fx * fx + one
    y = one - fx
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    return [c0, c1, c2, one - c0 - c1 - c2]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = [(1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45)]


def _lanczos4_coeffs(fx: np.float32) -> list:
    """OpenCV's ``interpolateLanczos4``: sines in double, coefficients and
    their normalisation in float32."""
    x3 = np.float32(fx + np.float32(3))
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = []
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        y0_ = np.float32(x3 - np.float32(i))
        if abs(y0_) >= 1e-6:
            y = -float(y0_) * math.pi * 0.25
            coeffs.append(np.float32((cs * s0 + cc * c0) / (y * y)))
        else:
            coeffs.append(np.float32(1e30))
    total = np.float32(0)
    for c in coeffs:
        total = np.float32(total + c)
    inv = np.float32(np.float32(1) / total)
    return [np.float32(c * inv) for c in coeffs]


def _tap_weights(ssize: int, dsize: int, taps: int, coeffs) -> np.ndarray:
    """``(dsize, ssize)`` float32 weights of OpenCV's generic resize along
    one axis: ``taps`` source pixels from ``floor(f) - taps/2 + 1``, ``f =
    (d + 0.5) * scale - 0.5`` in float32, the border replicated."""
    w = np.zeros((dsize, ssize), np.float32)
    scale = 1.0 / (dsize / ssize)
    for d in range(dsize):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        for k, c in enumerate(coeffs(np.float32(f - np.float32(s)))):
            w[d, min(max(s - taps // 2 + 1 + k, 0), ssize - 1)] += c
    return w


def _resize_taps(img, size, taps, coeffs) -> torch.Tensor:
    x = torch.as_tensor(img).float()
    w_out, h_out = size
    h, w = x.shape[:2]
    return _separable(x, _tap_weights(h, h_out, taps, coeffs),
                      _tap_weights(w, w_out, taps, coeffs))


def resize_cubic(img, size: tuple[int, int]) -> torch.Tensor:
    """``img`` (H, W[, C]) float -> (h, w[, C]) float32 for ``size = (w,
    h)``, OpenCV's INTER_CUBIC."""
    return _resize_taps(img, size, 4, _cubic_coeffs)


def resize_lanczos4(img, size: tuple[int, int]) -> torch.Tensor:
    """``img`` (H, W[, C]) float -> (h, w[, C]) float32 for ``size = (w,
    h)``, OpenCV's INTER_LANCZOS4."""
    return _resize_taps(img, size, 8, _lanczos4_coeffs)


def _reflect101(i: int, n: int) -> int:
    if n == 1:
        return 0
    while not 0 <= i < n:
        i = -i if i < 0 else 2 * n - 2 - i
    return i


def _blur_weights(n: int, kernel: np.ndarray) -> np.ndarray:
    """``(n, n)`` float32 weights of a 1-D filter with the border
    REFLECT_101."""
    r = len(kernel) // 2
    w = np.zeros((n, n), np.float32)
    for d in range(n):
        for k, c in enumerate(kernel):
            w[d, _reflect101(d + k - r, n)] += c
    return w


def gaussian_blur(img, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of an (H, W[, C]) float
    image, float32: a kernel of ``round(8 sigma + 1) | 1`` taps (OpenCV's
    size for float images), its values rounded to float32 and normalised as
    OpenCV's ``getGaussianKernel`` does, rows then columns."""
    x = torch.as_tensor(img).float()
    n = int(np.round(sigma * 4 * 2 + 1)) | 1
    t = np.exp(-0.5 / (sigma * sigma)
               * (np.arange(n) - (n - 1) * 0.5) ** 2).astype(np.float32)
    t = t.astype(np.float64)
    kernel = (t * (1.0 / t.sum())).astype(np.float32)
    h, w = x.shape[:2]
    return _separable(x, _blur_weights(h, kernel), _blur_weights(w, kernel))


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
