"""Text -> image generation (the native DiT pipeline), on the GPU.

The JAX package's ``motion324_tpu/hy3dgen/text2image.py`` (the reference's
``HunyuanDiTPipeline`` slot, scripts/hy3dgen/text2image.py:30-81):

- :class:`CLIPTextTower`: the CLIP text transformer (causal plain
  attention, quick-GELU, EOS pooling) as an ``nn.Module`` in f32;
  :func:`convert_clip_text` maps HF's ``CLIPTextModel`` state dict onto it;
- :class:`TextToImagePipeline`: the port's
  :class:`~motion324_tpu_torch.hy3dgen.dit.Hunyuan3DDiT` over patchified
  latents (its joint attention on K1 through the dispatcher), flow matching
  with CFG (the conditional and unconditional contexts as one batch of 2),
  and the SD VAE decode.

Module names follow the JAX package's flax names. Noise comes from a
``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT
from motion324_tpu_torch.hy3dgen.diffusion_common import as_f32, random_fill
from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu_torch.hy3dgen.sd_vae import SCALING_FACTOR, AutoencoderKL, Dense
from motion324_tpu_torch.models.motion_model import init_weights

__all__ = ["CLIPTextTower", "CLIPTextCfg", "convert_clip_text",
           "TextToImagePipeline"]


@dataclasses.dataclass(frozen=True)
class CLIPTextCfg:
    vocab: int = 49408
    hidden: int = 768
    intermediate: int = 3072
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    eos_token: int = 49407


class CLIPTextTower(nn.Module):
    """CLIP text transformer: ``(B, L)`` int tokens -> ``(per-token states
    (B, L, hidden), EOS-pooled embedding (B, hidden))``."""

    def __init__(self, cfg: CLIPTextCfg = CLIPTextCfg()):
        super().__init__()
        self.cfg = c = cfg
        self.token_embedding = nn.Parameter(torch.empty(c.vocab, c.hidden))
        self.position_embedding = nn.Parameter(torch.empty(c.max_len, c.hidden))
        for i in range(c.layers):
            for name in ("ln1", "ln2"):
                setattr(self, f"{name}_{i}", nn.LayerNorm(c.hidden, eps=1e-5))
            for name in ("q", "k", "v", "attn_out"):
                setattr(self, f"{name}_{i}", Dense(c.hidden, c.hidden))
            setattr(self, f"fc1_{i}", Dense(c.hidden, c.intermediate))
            setattr(self, f"fc2_{i}", Dense(c.intermediate, c.hidden))
        self.final_ln = nn.LayerNorm(c.hidden, eps=1e-5)

    def forward(self, tokens):
        c = self.cfg
        tokens = torch.as_tensor(tokens, device=self.token_embedding.device).long()
        b, L = tokens.shape
        hd = c.hidden // c.heads
        x = self.token_embedding[tokens] + self.position_embedding[None, :L]
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        heads = lambda t: t.reshape(b, L, c.heads, hd).transpose(1, 2)
        for i in range(c.layers):
            layer = lambda name: getattr(self, f"{name}_{i}")
            h = layer("ln1")(x)
            q, k, v = (heads(layer(n)(h)) for n in ("q", "k", "v"))
            a = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            a = torch.where(causal, a, torch.full_like(a, -1e9))
            o = torch.matmul(torch.softmax(a, -1), v)
            x = x + layer("attn_out")(o.transpose(1, 2).reshape(b, L, c.hidden))
            h = layer("fc1")(layer("ln2")(x))
            x = x + layer("fc2")(h * torch.sigmoid(1.702 * h))    # quick GELU
        x = self.final_ln(x)
        # the state at each sequence's first EOS token
        eos = (tokens == c.eos_token).int().argmax(1)
        return x, x[torch.arange(b, device=x.device), eos]


def convert_clip_text(state_dict: dict, cfg: CLIPTextCfg) -> dict:
    """HF torch ``CLIPTextModel`` state dict -> :class:`CLIPTextTower`'s."""
    def t(k):
        return as_f32(state_dict[k])

    out = {"token_embedding": t("text_model.embeddings.token_embedding.weight"),
           "position_embedding":
               t("text_model.embeddings.position_embedding.weight"),
           "final_ln.weight": t("text_model.final_layer_norm.weight"),
           "final_ln.bias": t("text_model.final_layer_norm.bias")}
    for i in range(cfg.layers):
        b = f"text_model.encoder.layers.{i}"
        pairs = [(f"{o}_{i}", f"{b}.self_attn.{s}") for o, s in (
            ("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
            ("attn_out", "out_proj"))]
        pairs += [(f"ln1_{i}", f"{b}.layer_norm1"), (f"ln2_{i}", f"{b}.layer_norm2"),
                  (f"fc1_{i}", f"{b}.mlp.fc1"), (f"fc2_{i}", f"{b}.mlp.fc2")]
        for ours, theirs in pairs:
            for kind in ("weight", "bias"):
                out[f"{ours}.{kind}"] = t(f"{theirs}.{kind}")
    return out


class TextToImagePipeline:
    """prompt tokens -> (H, W, 3) image in [0, 1]: CFG flow matching with
    the DiT over patchified latents, then the SD VAE decode.

    ``params``: ``{"text", "dit", "vae"}`` state dicts; empty for
    :meth:`init_random`. The text tower stays in f32; the DiT and the VAE
    are cast to ``dtype`` once, at construction.
    """

    def __init__(self, params: dict, *, image_size: int = 512,
                 latent_patch: int = 2, dit_hidden: int = 1024,
                 dit_heads: int = 16, dit_depth: int = 8, dit_single: int = 16,
                 text_cfg: CLIPTextCfg = CLIPTextCfg(),
                 vae: AutoencoderKL | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_backend: str | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.latent = image_size // 8
        self.patch = latent_patch
        self.tokens_per_side = self.latent // latent_patch
        self.lat_ch = 4 * latent_patch * latent_patch
        self.text = CLIPTextTower(text_cfg)
        self.dit = Hunyuan3DDiT(in_channels=self.lat_ch,
                                context_in_dim=text_cfg.hidden,
                                hidden_size=dit_hidden, num_heads=dit_heads,
                                depth=dit_depth, depth_single_blocks=dit_single,
                                attn_backend=attn_backend)
        self.vae = vae if vae is not None else AutoencoderKL()
        self.modules = (self.text, self.dit, self.vae)
        if params:
            for mod, key in zip(self.modules, ("text", "dit", "vae")):
                mod.load_state_dict(params[key])
        self.text.to(self.device).eval()
        self.dit.to(self.device, dtype).eval()
        self.vae.to(self.device, dtype).eval()

    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, *,
                    vae_kwargs: dict | None = None, **kw):
        """Seeded random weights drawn on the device (release width unless
        ``kw`` says otherwise), in the scale of the JAX package's
        initialisers; the CLIP embeddings are N(0, 0.02)."""
        device = resolve_device(kw.pop("device", None))
        gen = generator or torch.Generator(device).manual_seed(0)
        dtype = kw.pop("dtype", torch.bfloat16)
        with torch.device("meta"):
            self = cls({}, device="meta", dtype=dtype,
                       vae=AutoencoderKL(**(vae_kwargs or {})), **kw)
        with torch.no_grad():
            for mod in self.modules:
                mod.to_empty(device=device)
            init_weights(self.text, gen)
            init_weights(self.dit, gen)
            random_fill(self.vae, gen)
            for p in (self.text.token_embedding, self.text.position_embedding):
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
        self.device = device
        return self

    @torch.inference_mode()
    def denoise(self, x, ctx_pair, sigmas, guidance: float):
        """Flow-matching Euler steps over ``sigmas`` with CFG: each step one
        DiT call on the (cond, uncond) pair."""
        g = torch.tensor(guidance, dtype=torch.float32, device=x.device)
        sig = torch.as_tensor(np.ascontiguousarray(sigmas, np.float32),
                              device=x.device)
        for i in range(len(sigmas) - 1):
            s, s_next = sig[i], sig[i + 1]
            xx = torch.cat([x, x], 0)
            v = self.dit(xx, s.expand(2), ctx_pair)
            v_c, v_u = v.chunk(2, 0)
            x = x + (s_next - s) * (v_u + g * (v_c - v_u))
        return x

    @torch.inference_mode()
    def __call__(self, tokens, *, num_steps: int = 25, guidance_scale: float = 5.0,
                 seed: int = 0) -> torch.Tensor:
        """(L,) prompt tokens -> (H, W, 3) f32 image in [0, 1] on the
        device."""
        dev = self.device
        states, _ = self.text(torch.as_tensor(np.asarray(tokens))[None])
        ctx_pair = torch.cat([states, torch.zeros_like(states)], 0)
        n_tok = self.tokens_per_side ** 2
        gen = torch.Generator(dev).manual_seed(seed)
        x = torch.randn((1, n_tok, self.lat_ch), generator=gen, device=dev)
        x = self.denoise(x, ctx_pair, flow_match_sigmas(num_steps)[::-1],
                         guidance_scale)
        # unpatchify (1, g*g, p*p*4) -> (1, 4, g*p, g*p)
        g, p = self.tokens_per_side, self.patch
        z = x.reshape(1, g, g, p, p, 4).permute(0, 5, 1, 3, 2, 4)
        z = z.reshape(1, 4, g * p, g * p)
        img = self.vae.decode(z / SCALING_FACTOR)[0]
        return ((img + 1) / 2).clamp(0, 1).permute(1, 2, 0)
