"""I3D (Inflated 3D Inception-V1) video features for FVD, as an ``nn.Module``
(counterpart of ``motion324_tpu/evaluation/i3d.py``).

The same architecture as the JAX package's (Carreira & Zisserman 2017:
InceptionV1 inflated to 3D, BN eps 1e-3 in inference mode, TensorFlow
"SAME" padding for every convolution and pooling, Mixed_3b..Mixed_5c
inception blocks, a global average pool and a 1x1x1 logits convolution):
``(B, T, H, W, 3)`` clips in [-1, 1] -> ``(B, 400)`` logits. Module names
follow the JAX scopes (``Conv3d_1a_7x7.conv3d``, ``Mixed_4b.b1b.bn``,
``logits.conv3d``). Without weights the network is seeded and random: a
deterministic video embedding, enough for relative FVD regressions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.evaluation.video_metrics import (resize_frames,
                                                          seeded_init)

__all__ = ["I3D", "i3d_feature_fn", "I3D_CHANNELS"]

# inception branch channel plan (out1x1, red3x3, out3x3, red5x5_as3x3,
# out5x5_as3x3, pool_proj) per mixed block: the InceptionV1 table
I3D_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def _same_pad(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
              value: float = 0.0) -> torch.Tensor:
    """Pad ``(B, C, T, H, W)`` as TensorFlow's (and flax's) "SAME": a total
    of ``max((ceil(n / s) - 1) s + k - n, 0)`` per axis, the smaller half
    before."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _max_pool(x, kernel, stride):
    return F.max_pool3d(_same_pad(x, kernel, stride, float("-inf")), kernel,
                        stride)


class _Unit3D(nn.Module):
    """Conv3d + BatchNorm (inference) + ReLU, "SAME" padding."""

    def __init__(self, c_in: int, features: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(c_in, features, self.kernel, self.stride,
                                bias=not use_bn)
        self.bn = nn.BatchNorm3d(features, eps=1e-3) if use_bn else None
        self.activation = activation

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class _Inception(nn.Module):
    def __init__(self, c_in: int, c: Sequence[int]):
        super().__init__()
        self.b0 = _Unit3D(c_in, c[0])
        self.b1a = _Unit3D(c_in, c[1])
        self.b1b = _Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = _Unit3D(c_in, c[3])
        self.b2b = _Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = _Unit3D(c_in, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x):
        b3 = _max_pool(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], dim=1)


class I3D(nn.Module):
    """``(B, T, H, W, 3)`` in [-1, 1] -> ``(B, num_classes)`` logits."""

    def __init__(self, num_classes: int = 400, seed: int | None = 0):
        super().__init__()
        self.Conv3d_1a_7x7 = _Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = _Unit3D(64, 64)
        self.Conv3d_2c_3x3 = _Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, plan in I3D_CHANNELS.items():
            block = _Inception(c, plan)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = _Unit3D(c, num_classes, use_bn=False, activation=False)
        if seed is not None:
            seeded_init(self, seed)
        self.eval()

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.float().permute(0, 4, 1, 2, 3)          # (B, 3, T, H, W)
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _max_pool(x, (3, 3, 3), (2, 2, 2))
        for k in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, k)(x)
        x = _max_pool(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = x.mean(dim=(2, 3, 4), keepdim=True)   # global average pool
        return self.logits(x)[:, :, 0, 0, 0]


def i3d_feature_fn(state_dict: dict | None = None, model: I3D | None = None,
                   size: int = 224, seed: int = 0, device=None):
    """A ``feature_fn`` for :func:`compute_fvd`: ``(T, H, W, 3)`` in [0, 1]
    -> ``(400,)``, each frame resized to ``size``^2 (INTER_AREA) and scaled
    to [-1, 1]. ``state_dict`` loads into a new :class:`I3D` (random and
    seeded without one) on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    if model is None:
        model = I3D(seed=seed if state_dict is None else None)
        if state_dict is not None:
            model.load_state_dict(state_dict)
    model = model.to(dev).eval()

    @torch.no_grad()
    def feature_fn(video: np.ndarray) -> np.ndarray:
        v = resize_frames(np.asarray(video, np.float32), size) * 2.0 - 1.0
        return model(torch.from_numpy(v)[None].to(dev))[0].cpu().numpy()

    return feature_fn
