"""SD AutoencoderKL (the image VAE of texture diffusion), NCHW.

The JAX package's ``AutoencoderKL`` as ``nn.Module``s: four resolution
stages (128/256/512/512 channels at release width), GroupNorm (eps 1e-6,
the largest group count <= 32 that divides the channels) and SiLU resnets,
a mid block with single-head attention, 8x spatial downsampling to a
4-channel latent. The encoder downsamples with diffusers' asymmetric
(0, 1, 0, 1) padding; the decoder upsamples by nearest x2. The mid
attention is plain ``torch.matmul`` attention (the JAX package computes it
outside any kernel), its softmax in f32.

Module names follow the JAX package's flax names (``enc_0_res_1.conv2``
...), so ``utils.convert.paint_params_from_jax`` maps a flax tree onto the
state dict name for name. Computation runs in ``dtype``; normalisation
statistics are taken in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AutoencoderKL", "SCALING_FACTOR", "GroupNorm", "Conv", "Dense"]

SCALING_FACTOR = 0.18215


def _groups(c: int, groups: int = 32) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.GroupNorm):
    """GroupNorm with the largest group count <= 32 that divides the
    channels, computed as flax computes it: f32 statistics (variance as
    E[x^2] - E[x]^2, floored at 0), ``(x - mean) * rsqrt(var + eps)``, then
    the affine; output in the input's dtype. (PyTorch's fused kernel folds
    the mean into the affine and leaves a residue where a group is constant,
    as at the tiny widths' 1 x 1 latents.)"""

    def __init__(self, channels: int, eps: float):
        super().__init__(_groups(channels), channels, eps=eps)

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.float().reshape(b, self.num_groups, -1)
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, -1)
        y = y * self.weight.float()[:, None] + self.bias.float()[:, None]
        return y.reshape(x.shape).to(x.dtype)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class _Resnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 1e-6)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch, 1e-6)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class _MidAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c, 1e-6)
        self.to_q = Dense(c, c)
        self.to_k = Dense(c, c)
        self.to_v = Dense(c, c)
        self.to_out = Dense(c, c)

    def forward(self, x):
        b, c, h, w = x.shape
        flat = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        logits = torch.matmul(q, k.transpose(1, 2)).float() / (c ** 0.5)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.to_out(torch.matmul(attn, v))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class AutoencoderKL(nn.Module):
    def __init__(self, block_channels=(128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        chs = tuple(block_channels)
        self.block_channels = chs
        self.layers_per_block = layers_per_block
        self.latent_channels = latent_channels
        self.enc_conv_in = Conv(3, chs[0], 3, padding=1)
        prev = chs[0]
        for bi, ch in enumerate(chs):
            for li in range(layers_per_block):
                setattr(self, f"enc_{bi}_res_{li}", _Resnet(prev, ch))
                prev = ch
            if bi < len(chs) - 1:
                setattr(self, f"enc_{bi}_down", Conv(ch, ch, 3, stride=2))
        top = chs[-1]
        self.enc_mid_res0 = _Resnet(top, top)
        self.enc_mid_attn = _MidAttn(top)
        self.enc_mid_res1 = _Resnet(top, top)
        self.enc_norm_out = GroupNorm(top, 1e-6)
        self.enc_conv_out = Conv(top, 2 * latent_channels, 3, padding=1)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv(latent_channels, latent_channels, 1)
        self.dec_conv_in = Conv(latent_channels, top, 3, padding=1)
        self.dec_mid_res0 = _Resnet(top, top)
        self.dec_mid_attn = _MidAttn(top)
        self.dec_mid_res1 = _Resnet(top, top)
        prev = top
        for i, ch in enumerate(reversed(chs)):
            for li in range(layers_per_block + 1):
                setattr(self, f"dec_{i}_res_{li}", _Resnet(prev, ch))
                prev = ch
            if i < len(chs) - 1:
                setattr(self, f"dec_{i}_up", Conv(ch, ch, 3, padding=1))
        self.dec_norm_out = GroupNorm(chs[0], 1e-6)
        self.dec_conv_out = Conv(chs[0], 3, 3, padding=1)

    def encode(self, x):
        """(B, 3, H, W) -> (mean, logvar), each (B, 4, H/8, W/8)."""
        dtype = self.enc_conv_in.weight.dtype
        h = self.enc_conv_in(x.to(dtype))
        for bi in range(len(self.block_channels)):
            for li in range(self.layers_per_block):
                h = getattr(self, f"enc_{bi}_res_{li}")(h)
            if bi < len(self.block_channels) - 1:
                h = getattr(self, f"enc_{bi}_down")(F.pad(h, (0, 1, 0, 1)))
        h = self.enc_mid_res1(self.enc_mid_attn(self.enc_mid_res0(h)))
        h = self.enc_conv_out(F.silu(self.enc_norm_out(h)))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        return mean, logvar

    def decode(self, z):
        """(B, 4, h, w) latents -> (B, 3, 8h, 8w) f32 image."""
        dtype = self.post_quant_conv.weight.dtype
        h = self.dec_conv_in(self.post_quant_conv(z.to(dtype)))
        h = self.dec_mid_res1(self.dec_mid_attn(self.dec_mid_res0(h)))
        n = len(self.block_channels)
        for i in range(n):
            for li in range(self.layers_per_block + 1):
                h = getattr(self, f"dec_{i}_res_{li}")(h)
            if i < n - 1:
                h = getattr(self, f"dec_{i}_up")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.dec_conv_out(F.silu(self.dec_norm_out(h))).float()
