"""Foreground segmentation: U2Net and ISNet, and the border-statistics
fallback.

Counterpart of ``motion324_tpu/inference/segmentation.py``. The networks
are the public U-2-Net (``u2net.pth``) and DIS ``ISNetDIS``
(``isnet-general-use``) with their submodule names, so either released
state dict loads with ``load_state_dict`` as it is: ``stageN.rebnconvin``,
``stageN.rebnconvK`` / ``rebnconvKd`` (``conv_s1``, ``bn_s1``),
``side1..6``, ``outconv``, and ISNet's stem ``conv_in.{conv,bn}``.

The public functions take ``(B, H, W, 3)`` in [0, 1] and return ``(B, H,
W)``, as the JAX package's do; inside, the networks run in NCHW. The JAX
package's semantics are kept: 2x2 max pooling with SAME padding (ceil
mode), bilinear upsampling with half-pixel centres (``align_corners=False``,
which is what ``jax.image.resize`` computes when it enlarges), BatchNorm in
inference mode with eps 1e-5 whatever the module's mode, and the sigmoid
taken in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["U2Net", "ISNet", "RSU", "RSU4F", "segment_frames",
           "threshold_segment", "load_segmentation_state_dict"]


class _ConvBNReLU(nn.Module):
    """3x3 convolution, inference-mode BatchNorm, ReLU: the public
    ``REBNCONV`` (``conv_s1``, ``bn_s1``), or with ``names=("conv", "bn")``
    DIS's ``myrebnconv`` stem."""

    def __init__(self, cin: int, cout: int, dilation: int = 1, stride: int = 1,
                 names: tuple[str, str] = ("conv_s1", "bn_s1")):
        super().__init__()
        self._names = names
        setattr(self, names[0], nn.Conv2d(cin, cout, 3, stride=stride,
                                          padding=dilation, dilation=dilation))
        setattr(self, names[1], nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x):
        conv, bn = (getattr(self, n) for n in self._names)
        x = conv(x)
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _down(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x, target):
    if x.shape[2:] == target.shape[2:]:
        return x
    return F.interpolate(x, size=target.shape[2:], mode="bilinear",
                         align_corners=False)


class RSU(nn.Module):
    """Residual U-block of height ``height`` (U2Net's RSU7..RSU4)."""

    def __init__(self, height: int, cin: int, mid: int, out: int):
        super().__init__()
        self.height = height
        self.rebnconvin = _ConvBNReLU(cin, out)
        self.rebnconv1 = _ConvBNReLU(out, mid)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", _ConvBNReLU(mid, mid))
        setattr(self, f"rebnconv{height}", _ConvBNReLU(mid, mid, dilation=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", _ConvBNReLU(2 * mid, mid))
        self.rebnconv1d = _ConvBNReLU(2 * mid, out)

    def forward(self, x):
        xin = self.rebnconvin(x)
        h = self.rebnconv1(xin)
        encs = [h]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(_down(h))
            encs.append(h)
        h = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 0, -1):
            enc = encs[i - 1]
            h = getattr(self, f"rebnconv{i}d")(torch.cat([_up_to(h, enc), enc], 1))
        return h + xin


class RSU4F(nn.Module):
    """The dilated, pooling-free residual block of the deepest stages."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.rebnconvin = _ConvBNReLU(cin, out)
        self.rebnconv1 = _ConvBNReLU(out, mid, 1)
        self.rebnconv2 = _ConvBNReLU(mid, mid, 2)
        self.rebnconv3 = _ConvBNReLU(mid, mid, 4)
        self.rebnconv4 = _ConvBNReLU(mid, mid, 8)
        self.rebnconv3d = _ConvBNReLU(2 * mid, mid, 4)
        self.rebnconv2d = _ConvBNReLU(2 * mid, mid, 2)
        self.rebnconv1d = _ConvBNReLU(2 * mid, out, 1)

    def forward(self, x):
        xin = self.rebnconvin(x)
        h1 = self.rebnconv1(xin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        d1 = self.rebnconv1d(torch.cat([d2, h1], 1))
        return d1 + xin


class _Encoder(nn.Module):
    """The stages shared by U2Net and ISNet: RSU7..RSU4, two RSU4F, and the
    mirrored decoder; :meth:`features` returns (d1, d2, d3, d4, d5, s6)."""

    def __init__(self, cin, mids, outs, dec_mids, dec_outs):
        super().__init__()
        m, o, dm, do = mids, outs, dec_mids, dec_outs
        self.stage1 = RSU(7, cin, m[0], o[0])
        self.stage2 = RSU(6, o[0], m[1], o[1])
        self.stage3 = RSU(5, o[1], m[2], o[2])
        self.stage4 = RSU(4, o[2], m[3], o[3])
        self.stage5 = RSU4F(o[3], m[4], o[4])
        self.stage6 = RSU4F(o[4], m[5], o[5])
        self.stage5d = RSU4F(o[5] + o[4], dm[4], do[4])
        self.stage4d = RSU(4, do[4] + o[3], dm[3], do[3])
        self.stage3d = RSU(5, do[3] + o[2], dm[2], do[2])
        self.stage2d = RSU(6, do[2] + o[1], dm[1], do[1])
        self.stage1d = RSU(7, do[1] + o[0], dm[0], do[0])

    def features(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(_down(s1))
        s3 = self.stage3(_down(s2))
        s4 = self.stage4(_down(s3))
        s5 = self.stage5(_down(s4))
        s6 = self.stage6(_down(s5))
        cat = lambda a, b: torch.cat([_up_to(a, b), b], 1)
        d5 = self.stage5d(cat(s6, s5))
        d4 = self.stage4d(cat(d5, s4))
        d3 = self.stage3d(cat(d4, s3))
        d2 = self.stage2d(cat(d3, s2))
        d1 = self.stage1d(cat(d2, s1))
        return d1, d2, d3, d4, d5, s6


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype)


class U2Net(_Encoder):
    """U2Net saliency network, full size: ``(B, H, W, 3)`` in [0, 1] ->
    ``(B, H, W)`` probabilities in float32. Computes in the dtype of its
    parameters."""

    def __init__(self):
        super().__init__(3, (32, 32, 64, 128, 256, 256),
                         (64, 128, 256, 512, 512, 512),
                         (16, 32, 64, 128, 256), (64, 64, 128, 256, 512))
        for i, c in enumerate((64, 64, 128, 256, 512, 512), 1):
            setattr(self, f"side{i}", nn.Conv2d(c, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        h0, w0 = x.shape[1:3]
        feats = self.features(_to_nchw(x, self.outconv.weight.dtype))
        sides = []
        for i, f in enumerate(feats, 1):
            s = getattr(self, f"side{i}")(f)
            if s.shape[2:] != (h0, w0):
                s = F.interpolate(s, size=(h0, w0), mode="bilinear",
                                  align_corners=False)
            sides.append(s)
        fused = self.outconv(torch.cat(sides, 1))
        return torch.sigmoid(fused[:, 0].float())


class ISNet(_Encoder):
    """IS-Net (DIS ``ISNetDIS``, ``isnet-general-use``): a stride-2 stem,
    the U2Net stages, and the mask as the sigmoid of ``side1`` upsampled to
    the input size. Channels default to the released model's; smaller ones
    make test configurations."""

    def __init__(self, mids=(32, 32, 64, 128, 256, 256),
                 outs=(64, 128, 256, 512, 512, 512),
                 dec_mids=(16, 32, 64, 128, 256),
                 dec_outs=(64, 64, 128, 256, 512), stem: int = 64):
        super().__init__(stem, mids, outs, dec_mids, dec_outs)
        self.conv_in = _ConvBNReLU(3, stem, stride=2, names=("conv", "bn"))
        self.side1 = nn.Conv2d(dec_outs[0], 1, 3, padding=1)

    def forward(self, x):
        h0, w0 = x.shape[1:3]
        hxin = self.conv_in(_to_nchw(x, self.side1.weight.dtype))
        side = self.side1(self.features(hxin)[0])
        side = F.interpolate(side, size=(h0, w0), mode="bilinear",
                             align_corners=False)
        return torch.sigmoid(side[:, 0].float())


def threshold_segment(frames: np.ndarray, border: int = 8,
                      sigma_factor: float = 4.0) -> np.ndarray:
    """Heuristic fallback on the host: ``(T, H, W, 3)`` -> ``(T, H, W)``
    float32, foreground where some channel lies more than ``sigma_factor``
    standard deviations from the mean colour of the frame's border."""
    frames = np.asarray(frames, np.float32)
    t, h, w, _ = frames.shape
    bmask = np.zeros((h, w), bool)
    bmask[:border] = bmask[-border:] = True
    bmask[:, :border] = bmask[:, -border:] = True
    border_pix = frames[:, bmask]
    mean = border_pix.mean(axis=1, keepdims=True)
    std = border_pix.std(axis=1, keepdims=True) + 1e-3
    dist = np.abs(frames.reshape(t, -1, 3) - mean) / std
    fg = (dist.max(axis=-1) > sigma_factor).reshape(t, h, w)
    return fg.astype(np.float32)


def load_segmentation_state_dict(src) -> dict:
    """A U2Net / ISNet state dict from a dict or a ``.pt``/``.pth`` path."""
    if isinstance(src, dict):
        return src
    return torch.load(src, map_location="cpu", weights_only=True)


def segment_frames(frames: np.ndarray, params=None, model: nn.Module | None = None,
                   threshold: float = 0.5, batch: int = 8,
                   device=None) -> np.ndarray:
    """``(T, H, W, 3)`` frames in [0, 1] -> ``(T, H, W)`` float32 mask.

    With ``params`` (a state dict or a path) the network ``model`` (default
    a new :class:`U2Net`) loads them and segments ``batch`` frames at a
    time on ``device`` (CUDA unless the caller asks for the CPU); without,
    :func:`threshold_segment`.
    """
    if params is None:
        return threshold_segment(frames)
    from motion324_tpu_torch import resolve_device
    dev = resolve_device(device)
    model = model if model is not None else U2Net()
    model.load_state_dict(load_segmentation_state_dict(params))
    model = model.to(dev).eval()
    outs = []
    with torch.inference_mode():
        for i in range(0, len(frames), batch):
            x = torch.as_tensor(np.asarray(frames[i:i + batch], np.float32))
            outs.append(model(x.to(dev)).cpu().numpy())
    return (np.concatenate(outs) > threshold).astype(np.float32)
