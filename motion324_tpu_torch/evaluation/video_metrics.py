"""Video metrics: evaluation protocol, PSNR/SSIM, LPIPS (VGG), Fréchet/FVD
(counterpart of ``motion324_tpu/evaluation/video_metrics.py``).

- protocol: resize to 512^2 (OpenCV's INTER_AREA through the port's
  :func:`~motion324_tpu_torch.utils.image.resize_area`, no cv2),
  reflect-pad to a minimum of 32 frames, split into 32-frame subvideos;
- PSNR/SSIM as weight-free per-frame metrics and the Fréchet distance of
  two feature sets (numpy and scipy on the host, as in the JAX package);
- LPIPS: :class:`LPIPSVGG`, an ``nn.Module`` holding VGG16's feature stack
  in torchvision's ``vgg16.features`` layout (so its state dict loads as
  it is) and the five 1x1 linear heads of the ``lpips`` package; it runs on
  the module's device, frames in batches.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["prepare_video", "split_subvideos", "psnr", "ssim",
           "frechet_distance", "compute_fvd", "LPIPSVGG", "lpips_distance",
           "resize_frames"]


# --------------------------------------------------------------------------- #
# protocol
# --------------------------------------------------------------------------- #
def resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """``(T, H, W, C)`` float frames -> ``(T, size, size, C)`` float32,
    ``cv2.resize(f, (size, size), interpolation=INTER_AREA)`` per frame."""
    from motion324_tpu_torch.utils.image import resize_area
    return np.stack([resize_area(np.ascontiguousarray(f, np.float32),
                                 (size, size)).numpy() for f in frames])


def prepare_video(frames: np.ndarray, size: int = 512,
                  min_frames: int = 32) -> np.ndarray:
    """(T, H, W, 3) [0,1] -> resized to ``size``^2, reflect-padded to
    >= ``min_frames``."""
    out = resize_frames(frames, size)
    t = len(out)
    if t < min_frames:
        if t == 1:
            idx = np.zeros(min_frames, np.int64)
        else:
            period = 2 * t - 2
            idx = np.arange(min_frames) % period
            idx = np.where(idx < t, idx, period - idx)
        out = out[idx]
    return out.astype(np.float32)


def split_subvideos(frames: np.ndarray, length: int = 32,
                    verbose: bool = False) -> list[np.ndarray]:
    """Non-overlapping ``length``-frame subvideos: a shorter video is padded
    by reflecting trailing frames until it reaches ``length``; a longer one
    is cut into full chunks and the tail (< ``length`` frames) dropped."""
    frames = np.asarray(frames)
    t = len(frames)
    while t < length:  # reflect-pad (repeat for very short clips)
        pad = frames[-min(length - t, max(t - 1, 1)):][::-1]
        frames = np.concatenate([frames, pad], axis=0)
        t = len(frames)
    n_full = t // length
    dropped = t - n_full * length
    if dropped and verbose:
        print(f"split_subvideos: dropping {dropped} tail frame(s) "
              f"(protocol keeps full {length}-frame chunks only)")
    return [frames[i * length:(i + 1) * length] for i in range(n_full)]


# --------------------------------------------------------------------------- #
# pixel metrics
# --------------------------------------------------------------------------- #
def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         sigma: float = 1.5) -> float:
    """Mean SSIM with gaussian windows (channels averaged)."""
    from scipy.ndimage import gaussian_filter
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mx = gaussian_filter(x, sigma)
        my = gaussian_filter(y, sigma)
        mxx = gaussian_filter(x * x, sigma)
        myy = gaussian_filter(y * y, sigma)
        mxy = gaussian_filter(x * y, sigma)
        vx = mxx - mx * mx
        vy = myy - my * my
        cov = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / \
            ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


# --------------------------------------------------------------------------- #
# Fréchet distance / FVD
# --------------------------------------------------------------------------- #
def frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """Fréchet distance between two gaussian fits (scipy ``sqrtm`` of the
    covariance product)."""
    from scipy import linalg
    mu1, mu2 = feats1.mean(0), feats2.mean(0)
    s1 = np.cov(feats1, rowvar=False)
    s2 = np.cov(feats2, rowvar=False)
    diff = mu1 - mu2
    # sqrtm's ``disp`` keyword is gone from recent scipy; its default
    # returns the root alone
    covmean = linalg.sqrtm(s1 @ s2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def compute_fvd(videos1: list[np.ndarray], videos2: list[np.ndarray],
                feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """FVD with a pluggable video-feature extractor (I3D-class).

    ``feature_fn``: (T, H, W, 3) -> (D,) feature vector per video.
    """
    f1 = np.stack([feature_fn(v) for v in videos1])
    f2 = np.stack([feature_fn(v) for v in videos2])
    return frechet_distance(f1, f2)


# --------------------------------------------------------------------------- #
# LPIPS (VGG16 backbone + linear heads)
# --------------------------------------------------------------------------- #
def seeded_init(module: nn.Module, seed: int) -> None:
    """Seeded random weights with flax's default initialisers: convolution
    and dense kernels lecun-normal (std 1/sqrt(fan_in)), biases 0, norm
    scales 1; embedding tables and other parameters (tokens) N(0, 0.02).
    Drawn on the parameters' device (a module built under ``torch.device(
    "cuda")`` draws there), in ``named_parameters`` order."""
    params = list(module.named_parameters())
    gen = torch.Generator(device=params[0][1].device).manual_seed(seed)
    with torch.no_grad():
        for name, p in params:
            owner = module.get_submodule(name.rpartition(".")[0])
            randn = lambda: torch.randn(p.shape, generator=gen, device=p.device)
            if name.endswith("bias"):
                p.zero_()
            elif isinstance(owner, (nn.LayerNorm, nn.BatchNorm3d)):
                p.fill_(1.0)
            elif (p.dim() >= 2 and name.endswith("weight")
                  and not isinstance(owner, nn.Embedding)):
                p.copy_(randn() / math.sqrt(math.prod(p.shape[1:])))
            else:
                p.copy_(randn() * 0.02)


class LPIPSVGG(nn.Module):
    """LPIPS(vgg): the perceptual distance over 5 VGG16 feature stages.

    ``features`` is torchvision's ``vgg16.features`` up to the last tapped
    ReLU: ``vgg_state_dict``, torchvision's ``features.{i}.weight/bias``,
    loads into it (its last max-pool unused); ``lins`` holds the ``lpips``
    package's five 1x1 heads (``lin{i}.model.1.weight`` flattened), or None
    for the head-less mean over channels. Without weights the backbone is
    seeded and random: a valid relative metric for regressions.
    """

    VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512)
    STAGES = (1, 3, 6, 9, 12)  # conv indices whose ReLU output is tapped

    def __init__(self, vgg_state_dict: dict | None = None, lins=None,
                 seed: int = 0):
        super().__init__()
        layers, c_in, conv_i, self._taps = [], 3, 0, []
        for spec in self.VGG_CFG:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(c_in, spec, 3, padding=1), nn.ReLU()]
            if conv_i in self.STAGES:
                self._taps.append(len(layers) - 1)
            c_in, conv_i = spec, conv_i + 1
        self.features = nn.Sequential(*layers)
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]),
                             persistent=False)
        if vgg_state_dict is None:
            seeded_init(self.features, seed)
        else:
            self.features.load_state_dict(
                {k.split(".", 1)[1]: torch.as_tensor(np.asarray(v))
                 for k, v in vgg_state_dict.items()
                 if int(k.split(".")[1]) < len(layers)})
        self.lins = None if lins is None else nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.asarray(w, np.float32)).reshape(-1),
                         requires_grad=False) for w in lins)

    def _feats(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x)
        return taps

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` images in [0, 1] -> ``(B,)`` LPIPS distances."""
        def prep(img):
            x = (img.float() * 2 - 1 - self.shift) / self.scale
            return x.permute(0, 3, 1, 2)

        d = torch.zeros(img1.shape[0], device=img1.device)
        for i, (a, b) in enumerate(zip(self._feats(prep(img1)),
                                       self._feats(prep(img2)))):
            a = a / (a.norm(dim=1, keepdim=True) + 1e-10)
            b = b / (b.norm(dim=1, keepdim=True) + 1e-10)
            diff = (a - b) ** 2
            if self.lins is not None:
                w = self.lins[i].clamp(min=0.0)  # lpips lin weights >= 0
                d = d + (diff * w[None, :, None, None]).sum(1).mean((1, 2))
            else:
                d = d + diff.mean(1).mean((1, 2))
        return d

    @torch.no_grad()
    def distance(self, img1: np.ndarray, img2: np.ndarray) -> float:
        """Images ``(H, W, 3)`` in [0, 1] -> the scalar LPIPS distance."""
        dev = self.shift.device
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
        return float(self(t(img1), t(img2))[0])


@torch.no_grad()
def lpips_distance(video1: np.ndarray, video2: np.ndarray,
                   model: LPIPSVGG | None = None, batch: int = 8) -> float:
    """Mean per-frame LPIPS over two aligned videos, ``batch`` frames per
    forward on the model's device."""
    model = model or LPIPSVGG()
    dev = model.shift.device
    t = min(len(video1), len(video2))
    out = []
    frames = lambda v, i: torch.as_tensor(np.ascontiguousarray(
        v[i:min(i + batch, t)], np.float32), device=dev)
    for i in range(0, t, batch):
        out.append(model(frames(video1, i), frames(video2, i)).double().cpu())
    return float(torch.cat(out).mean())
