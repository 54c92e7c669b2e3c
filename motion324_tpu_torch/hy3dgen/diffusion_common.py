"""What the port's diffusion pipelines share: the Euler-Ancestral update,
f32 step scalars, f32 conversion of arrays and state dicts, seeded random
modules, and the SD UNet + VAE pair read from a diffusers checkpoint.

The multiview paint diffusion, the img2img ControlNet pipeline, the IP2P
delighter, the x4 upscaler, text-to-image and HunyuanDiT import these from
here.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL, GroupNorm

__all__ = ["f32_scalars", "euler_ancestral", "as_f32", "host_arrays",
           "random_fill", "random_modules", "sd_modules_from_diffusers"]


def f32_scalars(device, *values) -> list[torch.Tensor]:
    """Scalars as f32 tensors on ``device``, so that the step math rounds
    as it does under ``jax.jit``."""
    return [torch.tensor(v, dtype=torch.float32, device=device) for v in values]


def euler_ancestral(x, eps, sigma, sigma_next, noise):
    """One Euler-Ancestral update from ``sigma`` to ``sigma_next`` (f32
    tensors) given the noise prediction ``eps`` and fresh ``noise``."""
    x0 = x - sigma * eps
    s_to2, s_from2 = sigma_next ** 2, sigma ** 2
    sigma_up = torch.sqrt(torch.clamp(
        s_to2 * (s_from2 - s_to2) / torch.clamp(s_from2, min=1e-12), min=0.0))
    sigma_down = torch.sqrt(torch.clamp(s_to2 - sigma_up ** 2, min=0.0))
    d = (x - x0) / torch.clamp(sigma, min=1e-12)
    return x0 + d * sigma_down + noise * sigma_up


def as_f32(a, device="cpu") -> torch.Tensor:
    """An array or a tensor as a detached f32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def host_arrays(sd: dict) -> dict:
    """A state dict's values as f32 numpy arrays."""
    return {k: as_f32(v).numpy() for k, v in sd.items()}


def random_fill(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights on the module's device, in the scale of the JAX
    package's initialisers: N(0, 1/fan_in) for Dense, Conv and Embed
    weights, zero biases, unit norm scales."""
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, (GroupNorm, torch.nn.LayerNorm))}
    with torch.no_grad():
        for p in module.parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=p.dtype) * fan_in ** -0.5)


def random_modules(device, gen: torch.Generator, *build) -> list:
    """The modules that the callables ``build`` construct, built without
    storage, then given it on ``device`` and filled by :func:`random_fill`
    (nothing is drawn on the host)."""
    with torch.device("meta"):
        mods = [b() for b in build]
    mods = [m.to_empty(device=device) for m in mods]
    for m in mods:
        random_fill(m, gen)
    return mods


def sd_modules_from_diffusers(unet_state_dict: dict, vae_state_dict: dict, *,
                              head_dim: int = 64):
    """A diffusers-layout SD UNet and AutoencoderKL -> ``(UNet2p5D,
    AutoencoderKL, {"unet": state dict, "vae": state dict})``, the widths,
    depths, camera (or noise-level class) table, the 2.5D attentions and
    IP-Adapter's projections read from the weights."""
    from motion324_tpu_torch.utils.convert import flax_to_state_dict
    from motion324_tpu_torch.utils.sd_convert import (convert_sd_unet,
                                                      convert_sd_vae)
    u = convert_sd_unet(host_arrays(unet_state_dict))["params"]
    v = convert_sd_vae(host_arrays(vae_state_dict))["params"]
    n_blocks = sum(1 for k in u if k.startswith("down_") and k.endswith("_res_0"))
    chs = tuple(u[f"down_{i}_res_0"]["conv1"]["kernel"].shape[-1]
                for i in range(n_blocks))
    block = u["down_0_tf_0"]["block_0"]
    unet = UNet2p5D(
        in_channels=u["conv_in"]["kernel"].shape[2],
        out_channels=u["conv_out"]["kernel"].shape[3], block_channels=chs,
        layers_per_block=sum(1 for k in u if k.startswith("down_0_res_")),
        context_dim=block["attn2"]["to_k"]["kernel"].shape[0],
        head_dim=head_dim,
        tf_depth=sum(1 for k in u["down_0_tf_0"] if k.startswith("block_")),
        num_camera_embeds=(u["camera_embedding"]["embedding"].shape[0]
                           if "camera_embedding" in u else 0),
        multiview="attn_refview" in block, ip_adapter="to_k_ip" in block["attn2"])
    vn = sum(1 for k in v if k.startswith("enc_") and k.endswith("_res_0"))
    vae = AutoencoderKL(
        block_channels=tuple(v[f"enc_{i}_res_0"]["conv1"]["kernel"].shape[-1]
                             for i in range(vn)),
        layers_per_block=sum(1 for k in v if k.startswith("enc_0_res_")))
    return unet, vae, {"unet": flax_to_state_dict(u),
                       "vae": flax_to_state_dict(v)}
