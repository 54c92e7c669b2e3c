"""Depth-ControlNet img2img with IP-Adapter image prompting, on the GPU.

The JAX package's ``motion324_tpu/hy3dgen/img2img.py`` as ``nn.Module``s
(reference: scripts/hy3dgen/texgen/utils/alignImg4Tex_utils.py:21-124, SD +
depth ControlNet + IP-Adapter-plus, and its SDXL variant ``HesModel``):

- :class:`ControlNet`: the UNet's down and mid path with a stride-8 hint
  encoder and zero-initialised 1x1 output convolutions, one residual per
  UNet skip plus a mid residual (diffusers' ``ControlNetModel`` contract);
- :class:`Resampler`: the IP-Adapter-plus perceiver, learned latent
  queries cross-attending to image patch tokens (and themselves) over
  ``depth`` layers, projected to the UNet's cross-attention width;
- the decoupled image-prompt cross-attention lives in
  :class:`~motion324_tpu_torch.hy3dgen.sd_unet.UNet2p5D` (``ip_adapter``);
- :class:`Img2ImgControlPipeline`: Euler-Ancestral sampling with CFG over
  two branches (each a ControlNet and a UNet call), the ControlNet
  conditioning scale, ``ip_scale`` 0.7 and the ``strength`` < 1 img2img
  mode.

Attention goes through the dispatcher (K1, K6, K2 or plain by shape);
``attn_backend="plain"`` sends all of it to the plain version. Module names
follow the JAX package's flax names, so
:func:`motion324_tpu_torch.utils.convert.diffusion_params_from_jax` maps its
params onto these state dicts. Noise comes from a ``torch.Generator`` on the
device seeded with ``seed``: the initial latents first, then one draw per
step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.diffusion_common import (
    as_f32, euler_ancestral, f32_scalars, random_modules)
from motion324_tpu_torch.hy3dgen.paint_diffusion import sd_sigmas
from motion324_tpu_torch.hy3dgen.sd_unet import (UNet2p5D, _LayerNorm,
                                                 _ResnetBlock, _Transformer2D,
                                                 _plain_mha, time_embedding)
from motion324_tpu_torch.hy3dgen.sd_vae import (SCALING_FACTOR, AutoencoderKL,
                                                Conv, Dense)
from motion324_tpu_torch.ops.attention import multi_head_attention

__all__ = ["ControlNet", "Resampler", "Img2ImgControlPipeline"]


class _HintEncoder(nn.Module):
    """Full-resolution conditioning image -> latent-resolution features
    (stride 8), diffusers' ``ControlNetConditioningEmbedding``: 16 / 32 / 96
    / 256 channels, each step a stride-1 conv keeping the channels
    (``block_i_a``) and a stride-2 conv changing them (``block_i_b``); the
    final projection starts at zero."""

    def __init__(self, out_ch: int, channels=(16, 32, 96, 256)):
        super().__init__()
        self.channels = tuple(channels)
        self.conv_in = Conv(3, channels[0], 3, padding=1)
        for i, ch in enumerate(channels[1:]):
            setattr(self, f"block_{i}_a", Conv(channels[i], channels[i], 3,
                                               padding=1))
            setattr(self, f"block_{i}_b", Conv(channels[i], ch, 3, stride=2,
                                               padding=1))
        self.conv_out = Conv(channels[-1], out_ch, 3, padding=1)

    def forward(self, hint):
        h = F.silu(self.conv_in(hint))
        for i in range(len(self.channels) - 1):
            h = F.silu(getattr(self, f"block_{i}_a")(h))
            h = F.silu(getattr(self, f"block_{i}_b")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """The UNet's down and mid path emitting zero-conv residuals, one per
    skip and one after the mid block: ``(down_residuals, mid_residual)`` in
    f32, shaped like the skips of a :class:`UNet2p5D` with the same
    ``block_channels`` / ``layers_per_block``, scaled by
    ``conditioning_scale``."""

    def __init__(self, in_channels: int = 4,
                 block_channels=(320, 640, 1280, 1280), layers_per_block: int = 2,
                 context_dim: int = 768, head_dim: int = 64, tf_depth: int = 1,
                 attn_backend: str | None = None):
        super().__init__()
        chs = tuple(block_channels)
        self.block_channels = chs
        self.layers_per_block = layers_per_block
        ch0 = chs[0]
        temb = 4 * ch0
        self.time_fc1 = Dense(ch0, temb)
        self.time_fc2 = Dense(temb, temb)
        self.conv_in = Conv(in_channels, ch0, 3, padding=1)
        self.hint_encoder = _HintEncoder(ch0)
        tf = lambda ch: _Transformer2D(ch, ch // head_dim, context_dim, tf_depth,
                                       attn_backend, multiview=False)
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
        for i, ch in enumerate(skip_ch):
            setattr(self, f"zero_conv_{i}", Conv(ch, ch, 1))
        self.n_skips = len(skip_ch)
        self.zero_conv_mid = Conv(top, top, 1)

    def zero_modules(self) -> list[nn.Module]:
        """The convolutions that start at zero (the JAX package's
        initialiser): the hint encoder's output and the residual convs."""
        return [self.hint_encoder.conv_out, self.zero_conv_mid,
                *(getattr(self, f"zero_conv_{i}") for i in range(self.n_skips))]

    def forward(self, x, t, context, hint, conditioning_scale=1.0):
        dtype = self.conv_in.weight.dtype
        temb = time_embedding(self, t, x.device, dtype)
        context = context.to(dtype)
        kw = dict(n_views=1, mode="", ref_scale=0.0, mva_scale=0.0,
                  mva_masks=None)
        tf = lambda name, h: getattr(self, name)(h, context, name, None, {}, **kw)
        h = self.conv_in(x.to(dtype)) + self.hint_encoder(hint.to(dtype))
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
        h = self.mid_res_1(tf("mid_tf", self.mid_res_0(h, temb)), temb)
        down = [conditioning_scale * getattr(self, f"zero_conv_{i}")(s).float()
                for i, s in enumerate(skips)]
        return down, conditioning_scale * self.zero_conv_mid(h).float()


class Resampler(nn.Module):
    """IP-Adapter-plus perceiver: ``(B, N, feature_dim)`` image patch tokens
    -> ``(B, num_queries, output_dim)`` f32 prompt tokens."""

    def __init__(self, dim: int = 768, depth: int = 4, heads: int = 12,
                 num_queries: int = 16, output_dim: int = 768, ff_mult: int = 4,
                 feature_dim: int = 768, attn_backend: str | None = None):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.num_queries = num_queries
        self.attn_backend = attn_backend
        self.proj_in = Dense(feature_dim, dim)
        self.latents = nn.Parameter(torch.empty(num_queries, dim))
        for i in range(depth):
            for name in ("ln_q", "ln_kv", "ln_ff"):
                setattr(self, f"{name}_{i}", _LayerNorm(dim, 1e-6))
            for name in ("to_q", "to_k", "to_v", "to_out"):
                setattr(self, f"{name}_{i}", Dense(dim, dim, bias=False))
            setattr(self, f"ff_in_{i}", Dense(dim, dim * ff_mult, bias=False))
            setattr(self, f"ff_out_{i}", Dense(dim * ff_mult, dim, bias=False))
        self.proj_out = Dense(dim, output_dim)
        self.norm_out = _LayerNorm(output_dim, 1e-6)

    def forward(self, image_features):
        dtype = self.proj_in.weight.dtype
        b = image_features.shape[0]
        nq, hd = self.num_queries, self.dim // self.heads
        x = self.proj_in(image_features.to(dtype))
        latents = self.latents[None].expand(b, -1, -1)
        for i in range(self.depth):
            layer = lambda name: getattr(self, f"{name}_{i}")
            q_in = layer("ln_q")(latents)
            # keys and values: the image tokens and the latents themselves
            kv = torch.cat([layer("ln_kv")(x), q_in], 1)
            q = layer("to_q")(q_in).reshape(b, nq, self.heads, hd)
            k = layer("to_k")(kv).reshape(b, kv.shape[1], self.heads, hd)
            v = layer("to_v")(kv).reshape(b, kv.shape[1], self.heads, hd)
            o = (_plain_mha(q, k, v) if self.attn_backend == "plain"
                 else multi_head_attention(q, k, v))
            latents = latents + layer("to_out")(o.reshape(b, nq, self.dim))
            hf = layer("ff_in")(layer("ln_ff")(latents))
            latents = latents + layer("ff_out")(F.gelu(hf, approximate="tanh"))
        return self.norm_out(self.proj_out(latents)).float()


class Img2ImgControlPipeline:
    """control image (+ init image, image prompt) -> image.

    ``params``: ``{"unet", "controlnet", "vae", "resampler"}`` state dicts
    and ``"text_cond"`` / ``"text_uncond"`` (1, L, C) prompt embeddings;
    empty for :meth:`init_random`. ``strength=1`` is pure generation guided
    by the control map and the image prompt; ``init_image`` with
    ``strength<1`` is the img2img refinement. Weights are cast to ``dtype``
    once, at construction.
    """

    def __init__(self, params: dict, *, unet: UNet2p5D | None = None,
                 controlnet: ControlNet | None = None,
                 vae: AutoencoderKL | None = None,
                 resampler: Resampler | None = None, context_dim: int = 768,
                 text_len: int = 77, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.context_dim = context_dim
        self.text_len = text_len
        self.unet = unet if unet is not None else UNet2p5D(
            in_channels=4, context_dim=context_dim, num_camera_embeds=0,
            multiview=False, ip_adapter=True)
        self.controlnet = controlnet if controlnet is not None else ControlNet(
            block_channels=self.unet.block_channels,
            layers_per_block=self.unet.layers_per_block,
            context_dim=context_dim, head_dim=self.unet.head_dim)
        self.vae = vae if vae is not None else AutoencoderKL()
        self.resampler = (resampler if resampler is not None
                          else Resampler(output_dim=context_dim))
        self.modules = (self.unet, self.controlnet, self.vae, self.resampler)
        if params:
            for mod, key in zip(self.modules,
                                ("unet", "controlnet", "vae", "resampler")):
                mod.load_state_dict(params[key])
        for mod in self.modules:
            mod.to(self.device, dtype).eval()
        self.text_cond = self.text_uncond = None
        if params:
            self.text_cond = as_f32(params["text_cond"], self.device)
            self.text_uncond = as_f32(params["text_uncond"], self.device)

    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, *,
                    ip_feature_dim: int = 1280, unet_kwargs: dict | None = None,
                    controlnet_kwargs: dict | None = None,
                    vae_kwargs: dict | None = None,
                    resampler_kwargs: dict | None = None, **kw):
        """Seeded random weights drawn on the device, release width unless
        the ``*_kwargs`` say otherwise; the ControlNet's zero convs start at
        zero, as the JAX package initialises them."""
        device = resolve_device(kw.pop("device", None))
        gen = generator or torch.Generator(device).manual_seed(0)
        ctx = kw.get("context_dim", 768)
        unet, = random_modules(device, gen, lambda: UNet2p5D(**{
            "in_channels": 4, "context_dim": ctx, "num_camera_embeds": 0,
            "multiview": False, "ip_adapter": True, **(unet_kwargs or {})}))
        mods = [unet] + random_modules(
            device, gen, lambda: ControlNet(**{
                "block_channels": unet.block_channels,
                "layers_per_block": unet.layers_per_block, "context_dim": ctx,
                "head_dim": unet.head_dim, **(controlnet_kwargs or {})}),
            lambda: AutoencoderKL(**(vae_kwargs or {})),
            lambda: Resampler(**{"output_dim": ctx, "feature_dim": ip_feature_dim,
                                 **(resampler_kwargs or {})}))
        with torch.no_grad():
            for m in mods[1].zero_modules():
                m.weight.zero_()
        self = cls({}, unet=mods[0], controlnet=mods[1], vae=mods[2],
                   resampler=mods[3], device=device, **kw)
        self.text_cond = as_f32(torch.randn(
            (1, self.text_len, ctx), generator=gen, device=device) * 0.02, device)
        self.text_uncond = torch.zeros_like(self.text_cond)
        return self

    @classmethod
    def from_diffusers(cls, unet_state_dict: dict, controlnet_state_dict: dict,
                       vae_state_dict: dict, resampler_state_dict: dict,
                       text_cond, text_uncond, *, head_dim: int = 64, **kw):
        """From released weights: a diffusers SD UNet with IP-Adapter's
        ``to_k_ip`` / ``to_v_ip`` under each ``attn2``, the depth ControlNet
        and the AutoencoderKL (``utils.sd_convert``); the resampler as a
        state dict of :class:`Resampler` (its torch layout varies by
        release). The widths are read from the weights."""
        from motion324_tpu_torch.hy3dgen.diffusion_common import (
            host_arrays, sd_modules_from_diffusers)
        from motion324_tpu_torch.utils.convert import flax_to_state_dict
        from motion324_tpu_torch.utils.sd_convert import convert_controlnet
        unet, vae, params = sd_modules_from_diffusers(
            unet_state_dict, vae_state_dict, head_dim=head_dim)
        c = convert_controlnet(host_arrays(controlnet_state_dict))["params"]
        controlnet = ControlNet(
            in_channels=c["conv_in"]["kernel"].shape[2],
            block_channels=unet.block_channels,
            layers_per_block=unet.layers_per_block,
            context_dim=unet.context_dim, head_dim=head_dim,
            tf_depth=unet.tf_depth)
        rs = {k: torch.as_tensor(v).float()
              for k, v in resampler_state_dict.items()}
        dim = rs["latents"].shape[1]
        resampler = Resampler(
            dim=dim, depth=sum(1 for k in rs if k.startswith("to_q_")),
            heads=dim // 64, num_queries=rs["latents"].shape[0],
            output_dim=rs["proj_out.weight"].shape[0],
            ff_mult=rs["ff_in_0.weight"].shape[0] // dim,
            feature_dim=rs["proj_in.weight"].shape[1])
        params.update(controlnet=flax_to_state_dict(c), resampler=rs,
                      text_cond=text_cond, text_uncond=text_uncond)
        return cls(params, unet=unet, controlnet=controlnet, vae=vae,
                   resampler=resampler, context_dim=unet.context_dim,
                   text_len=np.asarray(text_cond).shape[1], **kw)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> scaled latent means (B, 4, H/8, W/8)."""
        x = images.to(self.device).float().permute(0, 3, 1, 2) * 2 - 1
        return self.vae.encode(x)[0].float() * SCALING_FACTOR

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> (B, H, W, 3) f32 images in [0, 1]."""
        img = self.vae.decode(latents / SCALING_FACTOR)
        return ((img + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def resample(self, features) -> torch.Tensor:
        return self.resampler(torch.as_tensor(features, device=self.device))

    @torch.inference_mode()
    def step(self, x, hint, ctx_c, ctx_u, ip_c, ip_u, t: float, sigma: float,
             sigma_next: float, noise, guidance: float, cn_scale: float,
             ip_scale: float):
        """One Euler-Ancestral step with CFG over the (uncond, cond)
        branches, each a ControlNet call feeding a UNet call."""
        sigma, sigma_next, guidance = f32_scalars(x.device, sigma, sigma_next,
                                                  guidance)
        x_in = x * (1.0 / torch.sqrt(sigma ** 2 + 1.0))
        tt = torch.full((x.shape[0],), float(t), device=x.device)

        def branch(ctx, ip):
            res = self.controlnet(x_in, tt, ctx, hint, conditioning_scale=cn_scale)
            return self.unet(x_in, tt, ctx, control_residuals=res, ip_tokens=ip,
                             ip_scale=ip_scale)

        eps_u = branch(ctx_u, ip_u)
        eps_c = branch(ctx_c, ip_c)
        return euler_ancestral(x, eps_u + guidance * (eps_c - eps_u), sigma,
                               sigma_next, noise)

    @torch.inference_mode()
    def __call__(self, control_image, *, init_image=None, image_features=None,
                 prompt_embeds=None, negative_embeds=None, strength: float = 1.0,
                 num_steps: int = 20, guidance_scale: float = 8.0,
                 controlnet_conditioning_scale: float = 1.0,
                 ip_scale: float = 0.7, seed: int = 42) -> torch.Tensor:
        """(H, W, 3) control map in [0, 1] -> (H, W, 3) f32 image in [0, 1]
        on the device. Defaults are the reference's: 20 steps, guidance 8,
        seed 42, IP-Adapter scale 0.7."""
        dev = self.device
        hint = torch.as_tensor(control_image, device=dev).float()
        h, w = hint.shape[:2]
        hint = hint.permute(2, 0, 1)[None]
        ctx_c = (self.text_cond if prompt_embeds is None
                 else as_f32(prompt_embeds, dev))
        ctx_u = (self.text_uncond if negative_embeds is None
                 else as_f32(negative_embeds, dev))
        if image_features is not None:
            feats = torch.as_tensor(image_features, device=dev).float()
            ip_c = self.resample(feats)
            ip_u = self.resample(torch.zeros_like(feats))
        else:
            ip_c = ip_u = torch.zeros((1, self.resampler.num_queries,
                                       self.context_dim), device=dev)
        timesteps, sigmas = sd_sigmas(num_steps)
        gen = torch.Generator(dev).manual_seed(seed)
        shape = (1, 4, h // 8, w // 8)
        randn = lambda: torch.randn(shape, generator=gen, device=dev)
        start = 0
        if init_image is not None and strength < 1.0:
            start = min(int(num_steps * (1.0 - strength)), num_steps - 1)
            init = torch.as_tensor(init_image, device=dev).float()[None]
            x = self.encode(init) + randn() * float(sigmas[start])
        else:
            x = randn() * float(sigmas[0])
        for i in range(start, num_steps):
            x = self.step(x, hint, ctx_c, ctx_u, ip_c, ip_u, float(timesteps[i]),
                          float(sigmas[i]), float(sigmas[i + 1]), randn(),
                          float(guidance_scale),
                          float(controlnet_conditioning_scale), float(ip_scale))
        return self.decode(x)[0]
