"""SD-class conditional UNet with 2.5D multiview / reference attention, NCHW.

The JAX package's ``UNet2p5D`` (the HunyuanPaint denoiser) as
``nn.Module``s with PyTorch convolutions:

- SD topology: conv_in -> cross-attention down blocks -> mid -> up blocks
  with skip concatenation -> conv_out; GroupNorm(32) / SiLU resnets (eps
  1e-5) with the time embedding added; Transformer2D blocks (GroupNorm eps
  1e-6) with GEGLU feed-forwards; cross-attention to the learned text
  context;
- ``conv_in`` takes 12 channels: noisy latent, normal-map latent and
  position-map latent;
- the time embedding is the cos|sin ramp through a two-layer MLP, plus a
  camera-index embedding (49 slots);
- each transformer block adds REFERENCE attention: a ``w`` pass returns the
  pre-attention hidden states of every block, keyed by module path (the
  bank), and an ``r`` pass attends to that bank, repeated per view, scaled
  by ``ref_scale``; and MULTIVIEW attention over the tokens of all views at
  once, scaled by ``mva_scale``, restricted by a voxel mask where
  ``mva_masks`` (keyed by joint token count) holds one: a
  :class:`~motion324_tpu_torch.hy3dgen.voxel_attention.VoxelMask` goes to
  K7, a dense boolean mask to plain PyTorch;
- IP-Adapter's decoupled cross-attention (``ip_adapter=True``): image-prompt
  tokens get their own ``to_k_ip`` / ``to_v_ip`` projections in every text
  cross-attention, share its query, and their output is added with
  ``ip_scale`` before the shared ``to_out``;
- ControlNet injection: ``control_residuals = (down_list, mid)`` adds one
  residual to each skip connection and the mid residual after the mid
  block.

A plain SD UNet (img2img, the IP2P delighter, the x4 upscaler) is built
with ``multiview=False`` (no reference or multiview attention) and
``num_camera_embeds=0`` (no camera embedding), as the JAX package's flax
init leaves those modules out there.

All other attention goes through :func:`~motion324_tpu_torch.ops.attention.
multi_head_attention` (K1, K6, K2 or plain by shape); ``attn_backend=
"plain"`` sends every attention to its plain version, for comparisons.
Module names follow the JAX package's flax names. The output is f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.hy3dgen.sd_vae import Conv, Dense, GroupNorm
from motion324_tpu_torch.hy3dgen.voxel_attention import VoxelMask
from motion324_tpu_torch.models.transformer import gelu
from motion324_tpu_torch.ops.attention import mha_reference, multi_head_attention
from motion324_tpu_torch.ops.masked_attention import (masked_attention_reference,
                                                      masked_flash_attention)

__all__ = ["UNet2p5D"]

# above this many logits per head group the plain path takes one head at a
# time (the multiview logits at 24 576 tokens are 12 GB for 5 heads in f32)
_PLAIN_CHUNK = 1 << 28


def _plain_mha(q, k, v):
    """:func:`mha_reference` over ``(B, S, H, D)``, a head at a time when the
    logits are large."""
    b, sq, h, _ = q.shape
    if b * h * sq * k.shape[1] <= _PLAIN_CHUNK:
        return mha_reference(q, k, v)
    return torch.cat([mha_reference(q[:, :, i:i + 1], k[:, :, i:i + 1],
                                    v[:, :, i:i + 1]) for i in range(h)], 2)


class _Attention(nn.Module):
    """diffusers-style attention: q/k/v without bias, out projection with;
    with ``ip_adapter`` also ``to_k_ip`` / ``to_v_ip`` for image-prompt
    tokens of width ``context_dim``."""

    def __init__(self, dim: int, heads: int, context_dim: int | None = None,
                 attn_backend: str | None = None, ip_adapter: bool = False):
        super().__init__()
        self.heads = heads
        self.attn_backend = attn_backend
        cdim = dim if context_dim is None else context_dim
        self.to_q = Dense(dim, dim, bias=False)
        self.to_k = Dense(cdim, dim, bias=False)
        self.to_v = Dense(cdim, dim, bias=False)
        if ip_adapter:
            self.to_k_ip = Dense(cdim, dim, bias=False)
            self.to_v_ip = Dense(cdim, dim, bias=False)
        self.to_out = Dense(dim, dim)

    def _mha(self, q, k, v):
        if self.attn_backend == "plain":
            return _plain_mha(q, k, v)
        return multi_head_attention(q, k, v)

    def forward(self, x, context=None, mask=None, ip_context=None,
                ip_scale=1.0):
        context = x if context is None else context
        b, l, dim = x.shape
        lc = context.shape[1]
        hd = dim // self.heads
        q = self.to_q(x).reshape(b, l, self.heads, hd)
        k = self.to_k(context).reshape(b, lc, self.heads, hd)
        v = self.to_v(context).reshape(b, lc, self.heads, hd)
        plain = self.attn_backend == "plain"
        if isinstance(mask, VoxelMask):
            # the turbo multiview mask, implicit in per-token cell positions
            fn = masked_attention_reference if plain else masked_flash_attention
            out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     mask.positions, radius=mask.radius).transpose(1, 2)
        elif mask is not None:
            # a dense boolean mask (tests, small shapes)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits / math.sqrt(hd)
            logits = torch.where(mask[:, None], logits,
                                 torch.full_like(logits, -1e9))
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", w.float(),
                               v.float()).to(q.dtype)
        else:
            out = self._mha(q, k, v)
        out = out.reshape(b, l, dim)
        if ip_context is not None:
            li = ip_context.shape[1]
            k_ip = self.to_k_ip(ip_context).reshape(b, li, self.heads, hd)
            v_ip = self.to_v_ip(ip_context).reshape(b, li, self.heads, hd)
            out = out + ip_scale * self._mha(q, k_ip, v_ip).reshape(b, l, dim)
        return self.to_out(out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = Dense(dim, 2 * dim * mult)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * gelu(gate))


class _LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5, diffusers'; flax's default is 1e-6) with f32
    statistics, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class _Block2p5D(nn.Module):
    """BasicTransformerBlock + reference and multiview attention (those two
    only with ``multiview``)."""

    def __init__(self, dim: int, heads: int, context_dim: int,
                 attn_backend: str | None, multiview: bool = True,
                 ip_adapter: bool = False):
        super().__init__()
        self.norm1 = _LayerNorm(dim)
        self.attn1 = _Attention(dim, heads, attn_backend=attn_backend)
        if multiview:
            self.attn_refview = _Attention(dim, heads, attn_backend=attn_backend)
            self.attn_multiview = _Attention(dim, heads,
                                             attn_backend=attn_backend)
        self.norm2 = _LayerNorm(dim)
        self.attn2 = _Attention(dim, heads, context_dim, attn_backend, ip_adapter)
        self.norm3 = _LayerNorm(dim)
        self.ff = _GEGLU(dim)

    def forward(self, x, context, n_views: int, mode: str, ref_bank, bank_out,
                ref_scale, mva_scale, mva_masks, ip_tokens=None, ip_scale=1.0):
        h = self.norm1(x)
        x = x + self.attn1(h)
        b = x.shape[0] // n_views
        if "w" in mode:
            bank_out.append(h.reshape(b, n_views * h.shape[1], h.shape[2]))
        if "r" in mode:
            bank = (ref_bank if ref_bank is not None
                    else h.reshape(b, n_views * h.shape[1], h.shape[2]))
            bank = bank.repeat_interleave(n_views, 0)
            x = x + ref_scale * self.attn_refview(h, bank)
        if n_views > 1:
            hm = h.reshape(b, n_views * h.shape[1], h.shape[2])
            mask = None if mva_masks is None else mva_masks.get(hm.shape[1])
            ma = self.attn_multiview(hm, mask=mask)
            x = x + mva_scale * ma.reshape(b * n_views, h.shape[1], h.shape[2])
        x = x + self.attn2(self.norm2(x), context, ip_context=ip_tokens,
                           ip_scale=ip_scale)
        return x + self.ff(self.norm3(x))


class _Transformer2D(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, depth: int,
                 attn_backend: str | None, multiview: bool = True,
                 ip_adapter: bool = False):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(dim, 1e-6)
        self.proj_in = Dense(dim, dim)
        for i in range(depth):
            setattr(self, f"block_{i}",
                    _Block2p5D(dim, heads, context_dim, attn_backend, multiview,
                               ip_adapter))
        self.proj_out = Dense(dim, dim)

    def forward(self, x, context, name: str, bank: dict | None,
                record: dict, **kw):
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_in(h)
        for i in range(self.depth):
            key = f"{name}.block_{i}"
            out: list = []
            h = getattr(self, f"block_{i}")(
                h, context, ref_bank=None if bank is None else bank[key],
                bank_out=out, **kw)
            if out:
                record[key] = out[0]
        h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return h + x


class _ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 1e-5)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = Dense(temb_dim, out_ch)
        self.norm2 = GroupNorm(out_ch, 1e-5)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        self.shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


def time_embedding(mod: nn.Module, t, device, dtype):
    """The SD time embedding of ``mod`` (a UNet or ControlNet with
    ``time_fc1`` / ``time_fc2``): the cos|sin ramp over the first block's
    width, then the two-layer MLP."""
    half = mod.block_channels[0] // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=device).float() / half)
    ang = t.float()[:, None] * freqs[None]
    temb = torch.cat([torch.cos(ang), torch.sin(ang)], -1).to(dtype)
    return mod.time_fc2(F.silu(mod.time_fc1(temb)))


class UNet2p5D(nn.Module):
    """``(B*N, 12, H, W)`` latents -> ``(B*N, 4, H, W)`` f32 noise
    prediction. Views are folded into the batch (``n_views``); ``mode`` is
    ``"w"`` (return the reference bank as well), ``"r"`` (read
    ``ref_bank``) or ``""``. ``multiview=False`` leaves out the reference
    and multiview attentions, ``num_camera_embeds=0`` the camera embedding;
    ``ip_adapter=True`` adds the image-prompt projections."""

    def __init__(self, in_channels: int = 12, out_channels: int = 4,
                 block_channels=(320, 640, 1280, 1280), layers_per_block: int = 2,
                 context_dim: int = 1024, head_dim: int = 64, tf_depth: int = 1,
                 num_camera_embeds: int = 49, attn_backend: str | None = None,
                 multiview: bool = True, ip_adapter: bool = False):
        super().__init__()
        chs = tuple(block_channels)
        self.block_channels = chs
        self.layers_per_block = layers_per_block
        self.context_dim = context_dim
        self.head_dim = head_dim
        self.tf_depth = tf_depth
        ch0 = chs[0]
        temb = 4 * ch0
        self.time_fc1 = Dense(ch0, temb)
        self.time_fc2 = Dense(temb, temb)
        if num_camera_embeds:
            self.camera_embedding = nn.Embedding(num_camera_embeds, temb)
        self.conv_in = Conv(in_channels, ch0, 3, padding=1)

        def tf(ch):
            return _Transformer2D(ch, ch // head_dim, context_dim, tf_depth,
                                  attn_backend, multiview, ip_adapter)
        skip_ch = [ch0]
        prev = ch0
        for bi, ch in enumerate(chs):
            for li in range(layers_per_block):
                setattr(self, f"down_{bi}_res_{li}", _ResnetBlock(prev, ch, temb))
                prev = ch
                if bi < len(chs) - 1:
                    setattr(self, f"down_{bi}_tf_{li}", tf(ch))
                skip_ch.append(ch)
            if bi < len(chs) - 1:
                setattr(self, f"down_{bi}_downsample",
                        Conv(ch, ch, 3, stride=2, padding=1))
                skip_ch.append(ch)
        top = chs[-1]
        self.mid_res_0 = _ResnetBlock(top, top, temb)
        self.mid_tf = tf(top)
        self.mid_res_1 = _ResnetBlock(top, top, temb)
        for bi in reversed(range(len(chs))):
            ch = chs[bi]
            for li in range(layers_per_block + 1):
                setattr(self, f"up_{bi}_res_{li}",
                        _ResnetBlock(prev + skip_ch.pop(), ch, temb))
                prev = ch
                if bi < len(chs) - 1:
                    setattr(self, f"up_{bi}_tf_{li}", tf(ch))
            if bi > 0:
                setattr(self, f"up_{bi}_upsample", Conv(ch, ch, 3, padding=1))
        self.norm_out = GroupNorm(ch0, 1e-5)
        self.conv_out = Conv(ch0, out_channels, 3, padding=1)

    def forward(self, x, t, context, camera_ids=None, n_views: int = 1,
                mode: str = "", ref_bank: dict | None = None, ref_scale=1.0,
                mva_scale=1.0, mva_masks: dict | None = None,
                control_residuals=None, ip_tokens=None, ip_scale=1.0):
        dtype = self.conv_in.weight.dtype
        temb = time_embedding(self, t, x.device, dtype)
        if camera_ids is not None:
            temb = temb + self.camera_embedding(camera_ids).to(temb.dtype)
        record: dict = {}
        kw = dict(n_views=n_views, mode=mode, ref_scale=ref_scale,
                  mva_scale=mva_scale, mva_masks=mva_masks,
                  ip_tokens=None if ip_tokens is None else ip_tokens.to(dtype),
                  ip_scale=ip_scale)
        context = context.to(dtype)

        def tf(name, h):
            return getattr(self, name)(h, context, name, ref_bank, record, **kw)

        h = self.conv_in(x.to(dtype))
        skips = [h]
        n = len(self.block_channels)
        for bi in range(n):
            for li in range(self.layers_per_block):
                h = getattr(self, f"down_{bi}_res_{li}")(h, temb)
                if bi < n - 1:
                    h = tf(f"down_{bi}_tf_{li}", h)
                skips.append(h)
            if bi < n - 1:
                h = getattr(self, f"down_{bi}_downsample")(h)
                skips.append(h)
        if control_residuals is not None:
            # one residual per skip, rounded to the compute dtype where the
            # JAX package's next convolution rounds the sum
            down_res, mid_res = control_residuals
            if len(down_res) != len(skips):
                raise ValueError(f"{len(down_res)} control residuals for "
                                 f"{len(skips)} skips")
            skips = [(s + r).to(s.dtype) for s, r in zip(skips, down_res)]
        h = self.mid_res_0(h, temb)
        h = tf("mid_tf", h)
        h = self.mid_res_1(h, temb)
        if control_residuals is not None:
            h = (h + mid_res).to(h.dtype)
        for bi in reversed(range(n)):
            for li in range(self.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], 1)
                h = getattr(self, f"up_{bi}_res_{li}")(h, temb)
                if bi < n - 1:
                    h = tf(f"up_{bi}_tf_{li}", h)
            if bi > 0:
                h = getattr(self, f"up_{bi}_upsample")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        out = self.conv_out(F.silu(self.norm_out(h))).float()
        return (out, record) if "w" in mode else out
