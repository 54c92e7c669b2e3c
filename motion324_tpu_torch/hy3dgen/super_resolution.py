"""Latent 4x super-resolution of generated texture views, on the GPU.

The JAX package's ``motion324_tpu/hy3dgen/super_resolution.py`` (reference:
scripts/hy3dgen/texgen/utils/imagesuper_utils.py:18-35, diffusers'
``StableDiffusionUpscalePipeline`` around the SD x4 latent upscaler):

- the denoiser is :class:`~motion324_tpu_torch.hy3dgen.sd_unet.UNet2p5D`
  with a 7-channel ``conv_in`` (4 noisy latent + 3 low-resolution RGB at
  latent resolution), blocks (256, 512, 512, 1024), and the camera table
  as the 1 000-entry noise-level class embedding;
- the VAE has three stages, so latents sit at 1/4 scale and the decode is
  the 4x upscale (latent scale 0.08333);
- the low-resolution image is noise-augmented at ``noise_level`` steps of
  the DDPM forward process and the level goes to the class embedding;
- DDIM (eta 0) over linear betas, epsilon- or v-prediction, CFG over a
  learned or empty text context.

Without weights :class:`Upscaler` falls back to :func:`upscale_x4`:
OpenCV's Lanczos-4 resize plus a mild unsharp mask, computed here without
cv2 (:mod:`motion324_tpu_torch.utils.image`). Noise comes from a
``torch.Generator`` on the device seeded with ``seed``: the augmentation
noise first, then the initial latents.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.diffusion_common import (as_f32, f32_scalars,
                                                          random_modules)
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL
from motion324_tpu_torch.utils.image import gaussian_blur, resize_lanczos4
from motion324_tpu_torch.utils.logging import log

__all__ = ["Upscaler", "upscale_x4", "ddpm_alphas_cumprod", "SR_SCALING_FACTOR"]

SR_SCALING_FACTOR = 0.08333  # x4-upscaler VAE latent scaling


def ddpm_alphas_cumprod(num_train: int = 1000, beta_start: float = 1e-4,
                        beta_end: float = 2e-2) -> np.ndarray:
    """Cumulative alpha products of the linear-beta DDPM forward process."""
    betas = np.linspace(beta_start, beta_end, num_train, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def upscale_x4(image, sharpen: float = 0.3) -> torch.Tensor:
    """Weight-free 4x upscale of an (H, W, 3) image in [0, 1]: OpenCV's
    Lanczos-4 resize, then ``up + sharpen * (up - GaussianBlur(up, 1.5))``,
    clipped; f32 on the image's device."""
    x = torch.as_tensor(image).float()
    h, w = x.shape[:2]
    up = resize_lanczos4(x, (w * 4, h * 4))
    if sharpen > 0:
        up = up + sharpen * (up - gaussian_blur(up, 1.5))
    return up.clamp(0.0, 1.0)


class Upscaler:
    """Low-resolution image -> 4x image by latent diffusion conditioned on
    it.

    ``params``: ``{"unet", "vae"}`` state dicts and ``"text_cond"`` /
    ``"text_uncond"`` (1, L, C) embeddings; ``None`` (and no modules) gives
    the weight-free :func:`upscale_x4` fallback, logged once. Weights are
    cast to ``dtype`` once, at construction.
    """

    def __init__(self, params: dict | None, *, unet: UNet2p5D | None = None,
                 vae: AutoencoderKL | None = None, context_dim: int = 1024,
                 text_len: int = 77, prediction_type: str = "v",
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        if prediction_type not in ("epsilon", "v"):
            raise ValueError(f"prediction_type {prediction_type!r}")
        self.device = resolve_device(device)
        self.prediction_type = prediction_type
        self.context_dim = context_dim
        self.text_len = text_len
        self._alphas = ddpm_alphas_cumprod().astype(np.float32)
        self._warned_fallback = False
        self.unet = self.vae = self.text_cond = self.text_uncond = None
        if params is None and unet is None:
            return
        self.unet = unet if unet is not None else UNet2p5D(
            in_channels=7, out_channels=4, block_channels=(256, 512, 512, 1024),
            context_dim=context_dim, num_camera_embeds=1000, multiview=False)
        self.vae = vae if vae is not None else AutoencoderKL(
            block_channels=(128, 256, 512))
        if params:
            self.unet.load_state_dict(params["unet"])
            self.vae.load_state_dict(params["vae"])
            self.text_cond = as_f32(params["text_cond"], self.device)
            self.text_uncond = as_f32(params["text_uncond"], self.device)
        self.unet.to(self.device, dtype).eval()
        self.vae.to(self.device, dtype).eval()

    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, *,
                    unet_kwargs: dict | None = None,
                    vae_kwargs: dict | None = None, **kw):
        """Seeded random weights drawn on the device, release width unless
        ``unet_kwargs`` / ``vae_kwargs`` say otherwise."""
        device = resolve_device(kw.pop("device", None))
        gen = generator or torch.Generator(device).manual_seed(0)
        ctx = kw.get("context_dim", 1024)
        unet, vae = random_modules(
            device, gen, lambda: UNet2p5D(**{
                "in_channels": 7, "out_channels": 4,
                "block_channels": (256, 512, 512, 1024), "context_dim": ctx,
                "num_camera_embeds": 1000, "multiview": False,
                **(unet_kwargs or {})}),
            lambda: AutoencoderKL(**{"block_channels": (128, 256, 512),
                                     **(vae_kwargs or {})}))
        self = cls({}, unet=unet, vae=vae, device=device, **kw)
        self.text_cond = as_f32(torch.randn(
            (1, self.text_len, ctx), generator=gen, device=device) * 0.02, device)
        self.text_uncond = torch.zeros_like(self.text_cond)
        return self

    @classmethod
    def from_diffusers(cls, unet_state_dict: dict, vae_state_dict: dict,
                       text_cond, text_uncond, *, head_dim: int = 64, **kw):
        """From released x4-upscaler weights: the diffusers UNet (its
        ``class_embedding`` is the noise-level table) and its 3-stage
        AutoencoderKL; ``text_cond`` / ``text_uncond`` are prompt
        embeddings (the reference calls with an empty prompt)."""
        from motion324_tpu_torch.hy3dgen.diffusion_common import (
            sd_modules_from_diffusers)
        unet, vae, params = sd_modules_from_diffusers(
            unet_state_dict, vae_state_dict, head_dim=head_dim)
        params.update(text_cond=text_cond, text_uncond=text_uncond)
        return cls(params, unet=unet, vae=vae, context_dim=unet.context_dim,
                   text_len=np.asarray(text_cond).shape[1], **kw)

    @torch.inference_mode()
    def step(self, x, low_res, noise_level: int, t: float, a_t: float,
             a_prev: float, guidance: float):
        """One DDIM step (eta 0) with CFG: a conditional and an
        unconditional UNet call, each of the batch."""
        b = x.shape[0]
        a_t, a_prev, guidance = f32_scalars(x.device, a_t, a_prev, guidance)
        x_in = torch.cat([x, low_res], 1)
        tt = torch.full((b,), float(t), device=x.device)
        nl = torch.full((b,), int(noise_level), dtype=torch.int64,
                        device=x.device)
        m_c = self.unet(x_in, tt, self.text_cond.expand(b, -1, -1), nl)
        m_u = self.unet(x_in, tt, self.text_uncond.expand(b, -1, -1), nl)
        m = m_u + guidance * (m_c - m_u)
        sq_a, sq_1ma = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        if self.prediction_type == "epsilon":
            x0, eps = (x - sq_1ma * m) / sq_a, m
        else:  # v-prediction: v = sqrt(a) eps - sqrt(1 - a) x0
            x0, eps = sq_a * x - sq_1ma * m, sq_a * m + sq_1ma * x
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    @torch.inference_mode()
    def __call__(self, image, *, num_steps: int = 5, guidance_scale: float = 9.0,
                 noise_level: int = 20, seed: int = 0) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> (4H, 4W, 3) f32 in [0, 1] on the device.
        Defaults are the reference call's: 5 steps, an empty prompt, the
        diffusers pipeline's guidance 9 and noise level 20."""
        if self.unet is None:
            if not self._warned_fallback:
                self._warned_fallback = True
                log("Upscaler: no diffusion weights — Lanczos x4 fallback")
            return upscale_x4(torch.as_tensor(image, device=self.device))
        dev = self.device
        img = torch.as_tensor(image, device=dev).float()
        h, w = img.shape[:2]
        low = img.permute(2, 0, 1)[None] * 2.0 - 1.0
        gen = torch.Generator(dev).manual_seed(seed)
        a_nl = torch.tensor(self._alphas[noise_level], dtype=torch.float32,
                            device=dev)
        aug = torch.randn(low.shape, generator=gen, device=dev)
        low = torch.sqrt(a_nl) * low + torch.sqrt(1 - a_nl) * aug
        x = torch.randn((1, 4, h, w), generator=gen, device=dev)
        timesteps = np.linspace(999, 0, num_steps).round().astype(np.int64)
        for i, t in enumerate(timesteps):
            a_prev = (float(self._alphas[timesteps[i + 1]])
                      if i + 1 < num_steps else 1.0)
            x = self.step(x, low, noise_level, float(t),
                          float(self._alphas[t]), a_prev, guidance_scale)
        img = self.vae.decode(x / SR_SCALING_FACTOR)[0]
        return ((img + 1) / 2).clamp(0, 1).permute(1, 2, 0)
