"""Delight (shadow/highlight removal) for reference images.

The port's copy of ``motion324_tpu/hy3dgen/delight.py``:

- the per-channel colour recorrection that the reference always applies
  after its InstructPix2Pix delighter (reference: scripts/hy3dgen/texgen/
  utils/dehighlight_utils.py:38-66), re-matching the edited image's
  per-channel mean/std to the original's over the foreground (numpy on the
  host), and :func:`delight_image`;
- :class:`DelightDiffusion`, the diffusion editor (dehighlight_utils.py:
  22-110) on the GPU: the SD UNet at an 8-channel ``conv_in`` (noisy latent
  + image-condition latent, the IP2P layout) with 3-way classifier-free
  guidance and Euler-Ancestral steps. It plugs in as
  :func:`delight_image`'s ``editor``. The JAX package's two cv2 resizes are
  the port's own: INTER_AREA in (:func:`~motion324_tpu_torch.utils.image.
  resize_area`), INTER_CUBIC back out (:func:`~motion324_tpu_torch.utils.
  image.resize_cubic`).

Without diffusion weights, :func:`delight_image` applies a deterministic
de-shading approximation (divide out low-frequency luminance) followed by the
same recorrection, so downstream texture generation sees flattened lighting.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.diffusion_common import (
    as_f32, euler_ancestral, f32_scalars, random_modules)
from motion324_tpu_torch.hy3dgen.paint_diffusion import sd_sigmas
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import SCALING_FACTOR, AutoencoderKL
from motion324_tpu_torch.utils.image import resize_area, resize_cubic

__all__ = ["color_recorrection", "delight_image", "DelightDiffusion"]


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


class DelightDiffusion:
    """InstructPix2Pix-class diffusion delighter: ``(H, W, 3)`` image in [0,
    1] -> the delit image, a numpy array of the same size (the
    :func:`delight_image` ``editor`` interface; the caller still applies the
    colour recorrection).

    ``params``: ``{"unet", "vae"}`` state dicts and ``"text"``, the (1, L,
    C) prompt embedding; empty for :meth:`init_random`. Noise comes from a
    ``torch.Generator`` on the device seeded with ``seed``: the initial
    latents, then one draw per step. Weights are cast to ``dtype`` once, at
    construction.
    """

    def __init__(self, params: dict, *, image_size: int = 512,
                 text_len: int = 77, context_dim: int = 1024,
                 dtype: torch.dtype = torch.bfloat16, unet: UNet2p5D | None = None,
                 vae: AutoencoderKL | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.text_len = text_len
        self.context_dim = context_dim
        self.unet = unet if unet is not None else UNet2p5D(
            in_channels=8, context_dim=context_dim, num_camera_embeds=0,
            multiview=False)
        self.vae = vae if vae is not None else AutoencoderKL()
        if params:
            self.unet.load_state_dict(params["unet"])
            self.vae.load_state_dict(params["vae"])
        self.unet.to(self.device, dtype).eval()
        self.vae.to(self.device, dtype).eval()
        self.text = None if not params else as_f32(params["text"], self.device)

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
                "in_channels": 8, "context_dim": ctx, "num_camera_embeds": 0,
                "multiview": False, **(unet_kwargs or {})}),
            lambda: AutoencoderKL(**(vae_kwargs or {})))
        self = cls({}, unet=unet, vae=vae, device=device, **kw)
        self.text = as_f32(torch.randn((1, self.text_len, ctx), generator=gen,
                                       device=device) * 0.02, device)
        return self

    @classmethod
    def from_diffusers(cls, unet_state_dict: dict, vae_state_dict: dict,
                       text_embed, *, context_dim: int = 768,
                       head_dim: int = 64, **kw):
        """From released InstructPix2Pix weights: a diffusers SD1.5 UNet with
        an 8-channel ``conv_in`` and its AutoencoderKL (the modules
        dehighlight_utils.py:26-33 loads); ``text_embed`` is the prompt's
        (1, L, C) embedding. The widths are read from the weights."""
        from motion324_tpu_torch.hy3dgen.diffusion_common import (
            sd_modules_from_diffusers)
        unet, vae, params = sd_modules_from_diffusers(
            unet_state_dict, vae_state_dict, head_dim=head_dim)
        if unet.context_dim != context_dim:
            raise ValueError(f"the UNet's context is {unet.context_dim} wide, "
                             f"not {context_dim}")
        params["text"] = text_embed
        return cls(params, unet=unet, vae=vae, context_dim=context_dim,
                   text_len=np.asarray(text_embed).shape[1], **kw)

    @torch.inference_mode()
    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> scaled latent means (1, 4, H/8, W/8)."""
        x = image.to(self.device).float().permute(2, 0, 1)[None] * 2 - 1
        return self.vae.encode(x)[0].float() * SCALING_FACTOR

    @torch.inference_mode()
    def step(self, noisy, img_lat, text, t: float, sigma: float,
             sigma_next: float, noise, guidance_txt: float,
             guidance_img: float):
        """One Euler-Ancestral step with IP2P's 3-way CFG over (text +
        image, image only, unconditional) in one UNet call of batch 3."""
        sigma, sigma_next, g_txt, g_img = f32_scalars(
            noisy.device, sigma, sigma_next, guidance_txt, guidance_img)
        x3 = torch.cat([noisy, noisy, noisy], 0) * (
            1.0 / torch.sqrt(sigma ** 2 + 1.0))
        cond3 = torch.cat([img_lat, img_lat, torch.zeros_like(img_lat)], 0)
        zeros = torch.zeros_like(text)
        ctx3 = torch.cat([text, zeros, zeros], 0)
        tt = torch.full((3,), float(t), device=noisy.device)
        eps = self.unet(torch.cat([x3, cond3], 1), tt, ctx3)
        e_ti, e_i, e_u = eps.chunk(3, 0)
        e = e_u + g_img * (e_i - e_u) + g_txt * (e_ti - e_i)
        return euler_ancestral(noisy, e, sigma, sigma_next, noise)

    @torch.inference_mode()
    def __call__(self, image, *, num_steps: int = 20, guidance_txt: float = 1.5,
                 guidance_img: float = 1.0, seed: int = 0) -> np.ndarray:
        dev = self.device
        img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
        h0, w0 = img.shape[:2]
        img = resize_area(img, (self.image_size, self.image_size))
        img_lat = self.encode(img)
        timesteps, sigmas = sd_sigmas(num_steps)
        gen = torch.Generator(dev).manual_seed(seed)
        randn = lambda: torch.randn(img_lat.shape, generator=gen, device=dev)
        x = randn() * float(sigmas[0])
        for i in range(num_steps):
            x = self.step(x, img_lat, self.text, float(timesteps[i]),
                          float(sigmas[i]), float(sigmas[i + 1]), randn(),
                          guidance_txt, guidance_img)
        out = ((self.vae.decode(x / SCALING_FACTOR)[0] + 1) / 2).clamp(0, 1)
        out = out.permute(1, 2, 0)
        if (h0, w0) != tuple(out.shape[:2]):
            out = resize_cubic(out, (w0, h0))
        return out.cpu().numpy()
