"""Multiview texture diffusion (the HunyuanPaint equivalent), on the GPU.

The JAX package's ``MultiviewDiffusion``:

- VAE-encode the reference image and the per-view normal and position maps;
- learned text embeddings, no text encoder;
- per step a reference ``w`` pass records the bank, then ``r`` passes
  denoise all views jointly, with multiview attention tying them together:
  Euler-Ancestral over the scaled-linear SD sigmas with a CFG pair of ``r``
  passes (reference attention at ref_scale 1 and 0), or turbo: LCM steps on
  the DDIM grid with one ``r`` pass and voxel-masked multiview attention
  (K7);
- VAE-decode the final latents into the view images.

Noise comes from a ``torch.Generator`` on the device seeded with ``seed``:
first the initial latents, then one draw per step, each of the latents'
shape ``(N, 4, h, w)``. (JAX's PRNG stream cannot be reproduced; the tests
feed this stream to the JAX step functions.) Weights are cast to ``dtype``
once, at construction.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.diffusion_common import (
    euler_ancestral, f32_scalars, host_arrays, random_modules,
    sd_modules_from_diffusers)
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import SCALING_FACTOR, AutoencoderKL
from motion324_tpu_torch.hy3dgen.voxel_attention import (
    multi_resolution_mask, multi_resolution_positions)
from motion324_tpu_torch.utils.image import resize_area

__all__ = ["MultiviewDiffusion", "sd_sigmas", "lcm_schedule",
           "lcm_boundary_scalings"]


def _alphas_cumprod(num_train: int = 1000, beta_start: float = 0.00085,
                    beta_end: float = 0.012) -> np.ndarray:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def sd_sigmas(num_steps: int, num_train: int = 1000,
              beta_start: float = 0.00085, beta_end: float = 0.012):
    """Scaled-linear SD noise schedule -> (timesteps, sigmas[num_steps+1])."""
    alphas_cum = _alphas_cumprod(num_train, beta_start, beta_end)
    all_sigmas = np.sqrt((1 - alphas_cum) / alphas_cum)
    idx = np.linspace(num_train - 1, 0, num_steps).round().astype(np.int64)
    return idx.astype(np.float32), np.concatenate(
        [all_sigmas[idx], np.zeros(1)]).astype(np.float32)


def lcm_schedule(num_steps: int, ddim_steps: int = 30, num_train: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
    """Turbo timesteps on the DDIM sub-schedule ``round((i+1) T/ddim) - 1``,
    walked down from the top with stride ``ddim_steps // num_steps``.
    Returns ``(timesteps, alpha_cumprods, alpha_cumprods of the next
    selected timestep)`` (the last ``prev`` is 1 and unused)."""
    alphas_cum = _alphas_cumprod(num_train, beta_start, beta_end)
    step_ratio = num_train // ddim_steps
    ddim_t = ((np.arange(1, ddim_steps + 1) * step_ratio).round()
              .astype(np.int64) - 1)
    stride = max(1, ddim_steps // num_steps)
    t = ddim_t[np.arange(ddim_steps - 1, -1, -stride)[:num_steps]]
    ac_prev = np.concatenate([alphas_cum[t[1:]], np.ones(1)])
    return t, alphas_cum[t].astype(np.float64), ac_prev.astype(np.float64)


def lcm_boundary_scalings(timestep, sigma_data: float = 0.5,
                          timestep_scaling: float = 10.0):
    """LCM consistency boundary scalings ``(c_skip, c_out)``."""
    st = timestep_scaling * timestep
    c_skip = sigma_data ** 2 / (st ** 2 + sigma_data ** 2)
    c_out = st / (st ** 2 + sigma_data ** 2) ** 0.5
    return c_skip, c_out


class MultiviewDiffusion:
    """The paint pipeline's view synthesizer.

    ``params``: ``{"unet": state dict, "vae": state dict, "text_gen": (1,
    77, C), "text_ref": (1, 77, C)}``; empty for :meth:`init_random`.
    """

    def __init__(self, params: dict, *, unet: UNet2p5D | None = None,
                 vae: AutoencoderKL | None = None, text_len: int = 77,
                 context_dim: int = 1024, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.text_len = text_len
        self.context_dim = context_dim
        self.unet = unet if unet is not None else UNet2p5D(context_dim=context_dim)
        self.vae = vae if vae is not None else AutoencoderKL()
        if params:
            self.unet.load_state_dict(params["unet"])
            self.vae.load_state_dict(params["vae"])
        self.unet.to(self.device, dtype).eval()
        self.vae.to(self.device, dtype).eval()
        self.text_gen = self.text_ref = None
        if params:
            self.text_gen = self._commit(params["text_gen"])
            self.text_ref = self._commit(params["text_ref"])

    def _commit(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
            a, torch.Tensor) else a).to(self.device, self.dtype)

    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, *,
                    unet_kwargs: dict | None = None,
                    vae_kwargs: dict | None = None, **kw):
        """Seeded random weights drawn on the device (release width unless
        ``unet_kwargs`` / ``vae_kwargs`` say otherwise)."""
        device = resolve_device(kw.pop("device", None))
        gen = generator or torch.Generator(device).manual_seed(0)
        context_dim = kw.get("context_dim", 1024)
        unet, vae = random_modules(
            device, gen, lambda: UNet2p5D(context_dim=context_dim,
                                          **(unet_kwargs or {})),
            lambda: AutoencoderKL(**(vae_kwargs or {})))
        self = cls({}, unet=unet, vae=vae, device=device, **kw)
        shape = (1, self.text_len, context_dim)
        self.text_gen = self._commit(
            torch.randn(shape, generator=gen, device=device) * 0.02)
        self.text_ref = self._commit(
            torch.randn(shape, generator=gen, device=device) * 0.02)
        return self

    @classmethod
    def from_diffusers(cls, unet_state_dict: dict, vae_state_dict: dict,
                       text_gen=None, text_ref=None, *, head_dim: int = 64,
                       **kw):
        """From released HunyuanPaint weights: the ``unet.``-prefixed
        UNet2p5D state dict (diffusers layout; ``learned_text_clip_gen`` and
        ``learned_text_clip_ref`` are taken from it unless given) and its
        AutoencoderKL. The widths are read from the weights."""
        unet_sd = host_arrays(unet_state_dict)
        if text_gen is None:
            text_gen = unet_sd.pop("unet.learned_text_clip_gen")[None]
        if text_ref is None:
            text_ref = unet_sd.pop("unet.learned_text_clip_ref")[None]
        unet, vae, params = sd_modules_from_diffusers(unet_sd, vae_state_dict,
                                                      head_dim=head_dim)
        params.update(text_gen=np.asarray(text_gen, np.float32),
                      text_ref=np.asarray(text_ref, np.float32))
        return cls(params, unet=unet, vae=vae, context_dim=unet.context_dim,
                   text_len=params["text_gen"].shape[1], **kw)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> scaled latent means (B, 4, H/8, W/8)."""
        x = images.to(self.device).float().permute(0, 3, 1, 2) * 2 - 1
        return self.vae.encode(x)[0] * SCALING_FACTOR

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> (B, H, W, 3) f32 images in [0, 1]."""
        img = self.vae.decode(latents / SCALING_FACTOR)
        return ((img + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1)

    def _ref_bank(self, ref_lat, text_ref):
        zeros = torch.zeros_like(ref_lat)
        ref_in = torch.cat([ref_lat, zeros, zeros], 1)
        t0 = torch.zeros(1, device=self.device)
        cam0 = torch.zeros(1, dtype=torch.int64, device=self.device)
        return self.unet(ref_in, t0, text_ref, cam0, 1, "w")[1]

    @torch.inference_mode()
    def euler_step(self, noisy, ctrl, ref_lat, text_gen, text_ref, camera_ids,
                   t: float, sigma: float, sigma_next: float, noise,
                   guidance: float, mva_masks=None):
        """One Euler-Ancestral step with CFG: a ``w`` pass, then ``r``
        passes at ref_scale 1 and 0. The scalar math is f32, as under
        ``jax.jit``."""
        sigma, sigma_next, guidance = f32_scalars(noisy.device, sigma,
                                                  sigma_next, guidance)
        n_views = noisy.shape[0]
        bank = self._ref_bank(ref_lat, text_ref)
        x_in = torch.cat([noisy * (1.0 / torch.sqrt(sigma ** 2 + 1.0)),
                          ctrl.float()], 1)
        tt = torch.full((n_views,), float(t), device=noisy.device)
        run = lambda scale: self.unet(x_in, tt, text_gen, camera_ids, n_views,
                                      "r", bank, ref_scale=scale,
                                      mva_masks=mva_masks)
        eps_c, eps_u = run(1.0), run(0.0)
        eps = eps_u + guidance * (eps_c - eps_u)
        return euler_ancestral(noisy, eps, sigma, sigma_next, noise)

    @torch.inference_mode()
    def lcm_step(self, noisy, ctrl, ref_lat, text_gen, text_ref, camera_ids,
                 t: float, ac_t: float, ac_prev: float, noise, mva_masks=None):
        """One LCM (turbo) step, no CFG: a ``w`` pass and one ``r`` pass at
        ref_scale 1. Returns ``(denoised, the next step's latents)``."""
        tf, ac_t, ac_prev = f32_scalars(noisy.device, t, ac_t, ac_prev)
        n_views = noisy.shape[0]
        bank = self._ref_bank(ref_lat, text_ref)
        x_in = torch.cat([noisy, ctrl.float()], 1)
        tt = torch.full((n_views,), float(t), device=noisy.device)
        eps = self.unet(x_in, tt, text_gen, camera_ids, n_views, "r", bank,
                        ref_scale=1.0, mva_masks=mva_masks)
        x0 = (noisy - torch.sqrt(1.0 - ac_t) * eps) / torch.sqrt(ac_t)
        c_skip, c_out = lcm_boundary_scalings(tf)
        denoised = c_out * x0 + c_skip * noisy
        stepped = torch.sqrt(ac_prev) * denoised + torch.sqrt(1.0 - ac_prev) * noise
        return denoised, stepped

    @torch.inference_mode()
    def generate(self, ref_image, control_images, camera_ids=None,
                 num_steps: int = 30, guidance_scale: float = 3.0,
                 seed: int = 0, mva_masks=None, sampler: str = "euler"):
        """ref (H, W, 3), control (N, H, W, 6: normal + position), in [0, 1]
        -> (N, H, W, 3) f32 view images on the device. ``sampler="lcm"`` is
        the turbo path (pair it with ``mva_masks``)."""
        if sampler not in ("euler", "lcm"):
            raise ValueError(f"sampler must be 'euler' or 'lcm', got {sampler!r}")
        dev = self.device
        control = torch.as_tensor(control_images, device=dev).float()
        ref = torch.as_tensor(ref_image, device=dev).float()
        n_views = control.shape[0]
        ref_lat = self.encode(ref[None])
        ctrl = torch.cat([self.encode(control[..., :3]),
                          self.encode(control[..., 3:6])], 1)
        if camera_ids is None:
            camera_ids = torch.arange(n_views, device=dev) + 5
        text_gen = self.text_gen.expand(n_views, -1, -1)
        gen = torch.Generator(dev).manual_seed(seed)
        shape = (n_views, 4, ctrl.shape[2], ctrl.shape[3])
        randn = lambda: torch.randn(shape, generator=gen, device=dev)
        args = (ctrl, ref_lat, text_gen, self.text_ref, camera_ids)
        if sampler == "lcm":
            ts, ac, ac_prev = lcm_schedule(num_steps)
            x = randn()
            for i in range(len(ts)):
                denoised, x = self.lcm_step(x, *args, float(ts[i]), float(ac[i]),
                                            float(ac_prev[i]), randn(),
                                            mva_masks=mva_masks)
            x = denoised
        else:
            timesteps, sigmas = sd_sigmas(num_steps)
            x = randn() * float(sigmas[0])
            for i in range(num_steps):
                x = self.euler_step(x, *args, float(timesteps[i]),
                                    float(sigmas[i]), float(sigmas[i + 1]),
                                    randn(), float(guidance_scale),
                                    mva_masks=mva_masks)
        return self.decode(x)

    # the PaintPipeline synthesizer interface ---------------------------- #
    def __call__(self, cond_image, views, renders, turbo: bool = False,
                 turbo_steps: int = 8):
        """Six view images (device tensors, zero off the mesh) from the
        renders' normal and position maps and the reference image. Turbo:
        voxel-masked multiview attention and ``turbo_steps`` LCM steps
        instead of 30 CFG steps."""
        control = torch.stack([torch.cat([(r["normal"] + 1) / 2,
                                          r["position"] + 0.5], -1)
                               for r in renders])
        h = renders[0]["mask"].shape[0]
        ref = resize_area(np.asarray(cond_image, np.float32), (h, h))
        if turbo:
            imgs = self.generate(ref, control, num_steps=turbo_steps,
                                 sampler="lcm",
                                 mva_masks=self.turbo_masks(renders))
        else:
            imgs = self.generate(ref, control)
        return [img * r["mask"][..., None] for img, r in zip(imgs, renders)]

    @staticmethod
    def turbo_masks(renders, grid_resolutions=(32, 16, 8), dense: bool = False):
        """Voxel-locality masks from the views' position maps, keyed by joint
        token count: :class:`VoxelMask` (positions, radius) for K7, or with
        ``dense`` the (B, S, S) boolean masks. Background is exactly 1.0."""
        pos = torch.stack([r["position"] + 0.5 for r in renders])[None]
        bg = ~torch.stack([r["mask"] for r in renders])[None][..., None]
        pos = torch.where(bg, torch.ones_like(pos), pos.clamp(0.0, 0.999))
        build = multi_resolution_mask if dense else multi_resolution_positions
        return build(pos.float(), grid_resolutions)
