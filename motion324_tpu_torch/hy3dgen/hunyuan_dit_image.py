"""HunyuanDiT text-to-image denoiser (diffusers ``HunyuanDiT2DModel``
layout), on the GPU.

The JAX package's ``motion324_tpu/hy3dgen/hunyuan_dit_image.py`` (the
reference loads ``Tencent-Hunyuan/HunyuanDiT-v1.1-Diffusers-Distilled``,
scripts/hy3dgen/text2image.py:30-45) as ``nn.Module``s:

- patchify conv (patch 2) -> 40 blocks with U-ViT long skips in the latter
  half (cat + LayerNorm + linear);
- per block: AdaLayerNormShift (time shift only), self-attention with
  per-head q/k LayerNorm and 2-D rotary embeddings, cross-attention to the
  CLIP + T5 text states (RoPE on q only), a tanh-GELU MLP;
- conditioning: timestep MLP + T5 attention pool + image-meta-size Fourier
  embedding + style embedding through a two-layer extra embedder;
- text: T5 states projected 2048 -> 1024 after the CLIP states, a learned
  padding row where the mask is 0;
- output: AdaLayerNorm-continuous, linear head to patch^2 * 2 in_channels
  (epsilon and learned sigma).

Attention here is the plain version (f32 logits and softmax, the weights
rounded to v's dtype), as the JAX package computes it outside any kernel:
the head dim is 88 and the port's CUDA kernels take 64 only. PAG (perturbed
attention guidance) swaps the self-attention of chosen blocks for the
identity map. Linear layers compute in their weights' dtype and norms in
f32, as the flax modules do. The 2-D RoPE axis order is pinned as in the
JAX package (``rope_hw_order``, height half first). Module names follow the
flax names; :func:`convert_hunyuan_dit_image` maps a diffusers checkpoint
onto them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.diffusion_common import (as_f32, host_arrays,
                                                          random_fill)
from motion324_tpu_torch.hy3dgen.sd_vae import SCALING_FACTOR, AutoencoderKL
from motion324_tpu_torch.models.motion_model import init_weights
from motion324_tpu_torch.ops.attention import mha_reference

__all__ = ["HunyuanDiT2D", "convert_hunyuan_dit_image",
           "HunyuanDiTImagePipeline", "rope_2d"]


def _timestep_proj(t, dim: int = 256):
    """diffusers ``Timesteps(256, flip_sin_to_cos=True, freq_shift=0)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device).float() / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def rope_2d(gh: int, gw: int, head_dim: int, hw_order: bool = True):
    """2-D rotary tables ``(cos, sin)``, each (gh * gw, head_dim) f32 for
    row-major tokens: half the head dim rotates with the row, half with the
    column, each 1-D table in the repeat-interleaved real form."""
    def axis(pos, dim):
        freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        ang = np.outer(pos, freqs)
        return np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)

    rows = np.repeat(np.arange(gh), gw)
    cols = np.tile(np.arange(gw), gh)
    a, b = (rows, cols) if hw_order else (cols, rows)
    cos_a, sin_a = axis(a, head_dim // 2)
    cos_b, sin_b = axis(b, head_dim // 2)
    cos = np.concatenate([cos_a, cos_b], axis=1).astype(np.float32)
    sin = np.concatenate([sin_a, sin_b], axis=1).astype(np.float32)
    return torch.from_numpy(cos), torch.from_numpy(sin)


def _apply_rope(x, cos, sin):
    """x (B, H, S, D): diffusers' ``apply_rotary_emb``, real-pair form."""
    rotated = torch.stack([-x[..., 1::2], x[..., 0::2]], -1).reshape(x.shape)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class _Linear(nn.Linear):
    """``nn.Linear`` computing in its weight's dtype (flax's ``Dense`` with
    the module's dtype)."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class _LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-6) in f32, returning f32, as flax's LayerNorm does
    with f32 parameters."""

    def __init__(self, dim: int, affine: bool = True):
        super().__init__(dim, eps=1e-6, elementwise_affine=affine)

    def forward(self, x):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps)


class _PoolFeedTextProj(nn.Module):
    """PixArtAlphaTextProjection: linear_1 -> SiLU (in f32) -> linear_2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.linear_1 = _Linear(in_dim, hidden)
        self.linear_2 = _Linear(hidden, out)

    def forward(self, x):
        h = self.linear_1(x)
        return self.linear_2(F.silu(h.float()).to(h.dtype))


class _AttentionPool(nn.Module):
    """HunyuanDiTAttentionPool: the mean token prepended, a learned
    position table, the mean token the only query (8 heads)."""

    def __init__(self, length: int, dim: int, out_dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(length + 1, dim))
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, _Linear(dim, dim))
        self.c_proj = _Linear(dim, out_dim)

    def forward(self, x):
        b, l, d = x.shape
        x = torch.cat([x.mean(1, keepdim=True), x], 1)
        x = x + self.positional_embedding.to(x.dtype)
        hd = d // self.heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.heads, hd)
        k = self.k_proj(x).reshape(b, l + 1, self.heads, hd)
        v = self.v_proj(x).reshape(b, l + 1, self.heads, hd)
        return self.c_proj(mha_reference(q, k, v).reshape(b, 1, d))[:, 0]


class _HunyuanAttention(nn.Module):
    """diffusers Attention with ``qk_norm="layer_norm"`` and rotary
    embeddings (on q always, on k for self-attention only), in plain
    PyTorch. ``perturb`` (self-attention only) is PAG's identity map:
    ``to_out(to_v(x))``."""

    def __init__(self, dim: int, heads: int, context_dim: int | None = None):
        super().__init__()
        self.heads = heads
        cdim = dim if context_dim is None else context_dim
        self.to_q = _Linear(dim, dim)
        self.to_k = _Linear(cdim, dim)
        self.to_v = _Linear(cdim, dim)
        self.to_out = _Linear(dim, dim)
        self.norm_q = _LayerNorm(dim // heads)
        self.norm_k = _LayerNorm(dim // heads)

    def forward(self, x, context=None, rope=None, perturb: bool = False):
        self_attn = context is None
        context = x if context is None else context
        if perturb:
            if not self_attn:
                raise ValueError("PAG perturbs self-attention only")
            return self.to_out(self.to_v(context))
        b, l, dim = x.shape
        lc = context.shape[1]
        hd = dim // self.heads
        q = self.norm_q(self.to_q(x).reshape(b, l, self.heads, hd).transpose(1, 2))
        k = self.norm_k(self.to_k(context).reshape(b, lc, self.heads, hd)
                        .transpose(1, 2))
        v = self.to_v(context).reshape(b, lc, self.heads, hd)
        if rope is not None:
            q = _apply_rope(q, *rope)
            if self_attn:
                k = _apply_rope(k, *rope)
        o = mha_reference(q.transpose(1, 2), k.transpose(1, 2), v).to(v.dtype)
        return self.to_out(o.reshape(b, l, dim))


class _HunyuanBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int, skip: bool = False):
        super().__init__()
        if skip:
            self.skip_norm = _LayerNorm(2 * dim)
            self.skip_linear = _Linear(2 * dim, dim)
        self.norm1_linear = _Linear(dim, dim)
        self.norm1 = _LayerNorm(dim)
        self.attn1 = _HunyuanAttention(dim, heads)
        self.norm2 = _LayerNorm(dim)
        self.attn2 = _HunyuanAttention(dim, heads, ctx_dim)
        self.norm3 = _LayerNorm(dim)
        self.ff_in = _Linear(dim, 4 * dim)
        self.ff_out = _Linear(4 * dim, dim)

    def forward(self, x, ctx, temb, rope, skip_tensor=None, perturb: bool = False):
        if skip_tensor is not None:
            cat = torch.cat([x, skip_tensor], -1)
            x = self.skip_linear(self.skip_norm(cat).to(cat.dtype))
        # AdaLayerNormShift: the affine LN plus a time shift, no scale
        shift = self.norm1_linear(F.silu(temb.float()).to(temb.dtype))
        h = self.norm1(x) + shift[:, None]
        x = x + self.attn1(h, rope=rope, perturb=perturb)
        x = x + self.attn2(self.norm2(x).to(x.dtype), ctx, rope=rope)
        h = self.ff_in(self.norm3(x).to(x.dtype))
        return x + self.ff_out(F.gelu(h, approximate="tanh"))


class HunyuanDiT2D(nn.Module):
    """``(B, in_ch, H, W)`` latents -> ``(B, 2 in_ch, H, W)`` f32 epsilon |
    sigma prediction. Released v1.1 dims: hidden 1408 (16 heads x 88), 40
    blocks, patch 2, CLIP 1024 + T5 2048 -> 1024, style and image-meta-size
    conditioning."""

    def __init__(self, hidden: int = 1408, heads: int = 16, num_layers: int = 40,
                 patch: int = 2, in_channels: int = 4, ctx_dim: int = 1024,
                 t5_dim: int = 2048, text_len: int = 77, text_len_t5: int = 256,
                 use_style: bool = True, rope_hw_order: bool = True):
        super().__init__()
        self.hidden, self.heads, self.num_layers = hidden, heads, num_layers
        self.patch, self.in_channels = patch, in_channels
        self.text_len, self.text_len_t5 = text_len, text_len_t5
        self.use_style = use_style
        self.rope_hw_order = rope_hw_order
        self.pos_embed_proj = nn.Conv2d(in_channels, hidden, patch, stride=patch)
        self.timestep_embedder = _PoolFeedTextProj(256, hidden, hidden)
        self.pooler = _AttentionPool(text_len_t5, t5_dim, ctx_dim)
        extra = ctx_dim
        if use_style:
            self.style_embedder = nn.Embedding(1, hidden)
            extra += 6 * 256 + hidden
        self.extra_embedder = _PoolFeedTextProj(extra, 4 * hidden, hidden)
        self.text_embedder = _PoolFeedTextProj(t5_dim, 4 * t5_dim, ctx_dim)
        self.text_embedding_padding = nn.Parameter(
            torch.empty(text_len + text_len_t5, ctx_dim))
        half = num_layers // 2
        for i in range(num_layers):
            setattr(self, f"block_{i}", _HunyuanBlock(hidden, heads, ctx_dim,
                                                      skip=i > half))
        self.norm_out_linear = _Linear(hidden, 2 * hidden)
        self.norm_out = _LayerNorm(hidden, affine=False)
        self.proj_out = _Linear(hidden, patch * patch * 2 * in_channels)

    def forward(self, x, t, clip_states, t5_states, clip_mask=None, t5_mask=None,
                image_meta_size=None, style=None, pag_layers=()):
        """``pag_layers``: the blocks whose self-attention takes PAG's
        identity map (the reference perturbs blocks 16-19)."""
        dtype = self.pos_embed_proj.weight.dtype
        b, _, hh, ww = x.shape
        p = self.patch
        gh, gw = hh // p, ww // p
        dev = x.device
        h = self.pos_embed_proj(x.to(dtype)).flatten(2).transpose(1, 2)

        temb = self.timestep_embedder(_timestep_proj(t.to(dev)))
        pooled = self.pooler(t5_states.float())
        extra = pooled
        if self.use_style:
            if image_meta_size is None:
                image_meta_size = torch.tensor(
                    [[hh * 8, ww * 8, hh * 8, ww * 8, 0, 0]], dtype=torch.float32,
                    device=dev).expand(b, -1)
            size_emb = _timestep_proj(image_meta_size.to(dev).reshape(-1))
            style = (torch.zeros((b,), dtype=torch.int64, device=dev)
                     if style is None else style.to(dev).long())
            extra = torch.cat([pooled, size_emb.reshape(b, 6 * 256).to(pooled.dtype),
                               self.style_embedder(style).to(pooled.dtype)], -1)
        temb = temb + self.extra_embedder(extra)

        # the text states: CLIP, then T5 projected; the padding row where
        # the mask is 0
        t5_proj = self.text_embedder(t5_states.float())
        ctx = torch.cat([clip_states.float(), t5_proj.float()], 1)
        ones = lambda n: torch.ones((b, n), dtype=torch.bool, device=dev)
        mask = torch.cat([ones(self.text_len) if clip_mask is None
                          else clip_mask.to(dev).bool(),
                          ones(self.text_len_t5) if t5_mask is None
                          else t5_mask.to(dev).bool()], 1)
        ctx = torch.where(mask[..., None], ctx,
                          self.text_embedding_padding.float()[None])

        cos, sin = rope_2d(gh, gw, self.hidden // self.heads, self.rope_hw_order)
        rope = (cos.to(dev), sin.to(dev))

        # the U-ViT stack: the first half's outputs feed the second half
        half = self.num_layers // 2
        skips = []
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(
                h, ctx, temb, rope, skip_tensor=skips.pop() if i > half else None,
                perturb=i in pag_layers)
            if i < half - 1:
                skips.append(h)

        emb = self.norm_out_linear(F.silu(temb.float()).to(temb.dtype))
        scale, shift = emb.chunk(2, -1)
        h = self.norm_out(h).to(h.dtype) * (1 + scale[:, None]) + shift[:, None]
        out = self.proj_out(h).reshape(b, gh, gw, p, p, 2 * self.in_channels)
        out = out.permute(0, 5, 1, 3, 2, 4).reshape(b, 2 * self.in_channels, hh, ww)
        return out.float()


def convert_hunyuan_dit_image(state_dict: dict, *, num_layers: int = 40,
                              strict: bool = True) -> dict:
    """diffusers ``HunyuanDiT2DModel`` state dict -> :class:`HunyuanDiT2D`'s
    (f32). Strict: every checkpoint key must be used."""
    sd = {k: as_f32(v) for k, v in state_dict.items()}
    used: set = set()
    out: dict = {}

    def put(ours: str, theirs: str, kinds=("weight", "bias")):
        for kind in kinds:
            key = f"{theirs}.{kind}" if kind else theirs
            if kind == "bias" and key not in sd:
                continue
            used.add(key)
            out[f"{ours}.{kind}" if kind else ours] = sd[key]

    put("pos_embed_proj", "pos_embed.proj")
    for ours, theirs in (("timestep_embedder", "time_extra_emb.timestep_embedder"),
                         ("extra_embedder", "time_extra_emb.extra_embedder"),
                         ("text_embedder", "text_embedder")):
        put(f"{ours}.linear_1", f"{theirs}.linear_1")
        put(f"{ours}.linear_2", f"{theirs}.linear_2")
    put("pooler.positional_embedding",
        "time_extra_emb.pooler.positional_embedding", kinds=("",))
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        put(f"pooler.{name}", f"time_extra_emb.pooler.{name}")
    if "time_extra_emb.style_embedder.weight" in sd:
        put("style_embedder", "time_extra_emb.style_embedder", kinds=("weight",))
    put("text_embedding_padding", "text_embedding_padding", kinds=("",))
    put("norm_out_linear", "norm_out.linear")
    put("proj_out", "proj_out")
    half = num_layers // 2
    for i in range(num_layers):
        b, o = f"blocks.{i}", f"block_{i}"
        put(f"{o}.norm1", f"{b}.norm1.norm")
        put(f"{o}.norm1_linear", f"{b}.norm1.linear")
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v", "norm_q", "norm_k"):
                put(f"{o}.{a}.{n}", f"{b}.{a}.{n}")
            put(f"{o}.{a}.to_out", f"{b}.{a}.to_out.0")
        put(f"{o}.norm2", f"{b}.norm2")
        put(f"{o}.norm3", f"{b}.norm3")
        put(f"{o}.ff_in", f"{b}.ff.net.0.proj")
        put(f"{o}.ff_out", f"{b}.ff.net.2")
        if i > half:
            put(f"{o}.skip_norm", f"{b}.skip_norm")
            put(f"{o}.skip_linear", f"{b}.skip_linear")
    if strict:
        left = sorted(set(sd) - used)
        if left:
            raise KeyError(f"{len(left)} unconsumed HunyuanDiT keys, e.g. "
                           f"{left[:8]}")
    return out


class HunyuanDiTImagePipeline:
    """Text states -> (B, H, W, 3) images by the HunyuanDiT denoiser: DDIM
    over its epsilon prediction (the learned sigma dropped), scaled-linear
    betas 0.00085 .. 0.03 over 1 000 steps, CFG, and optionally PAG over
    ``pag_applied_layers``; the SD VAE decodes.

    ``params``: ``{"transformer", "vae"}`` state dicts; empty for
    :meth:`init_random`. Weights are cast to ``dtype`` once, at
    construction. Noise comes from a ``torch.Generator`` on the device
    seeded with ``seed``.
    """

    def __init__(self, params: dict, *, model: HunyuanDiT2D | None = None,
                 vae: AutoencoderKL | None = None, image_size: int = 1024,
                 beta_start: float = 0.00085, beta_end: float = 0.03,
                 num_train_timesteps: int = 1000,
                 pag_applied_layers: tuple = (16, 17, 18, 19),
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model if model is not None else HunyuanDiT2D()
        self.vae = vae if vae is not None else AutoencoderKL()
        if params:
            self.model.load_state_dict(params["transformer"])
            self.vae.load_state_dict(params["vae"])
        self.model.to(self.device, dtype).eval()
        self.vae.to(self.device, dtype).eval()
        self.image_size = image_size
        self.pag_applied_layers = tuple(
            i for i in pag_applied_layers if i < self.model.num_layers)
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        self._alphas = np.cumprod(1.0 - betas).astype(np.float32)
        self._num_train = num_train_timesteps

    @classmethod
    def init_random(cls, generator: torch.Generator | None = None, *,
                    model_kwargs: dict | None = None,
                    vae_kwargs: dict | None = None, **kw):
        """Seeded random weights drawn on the device in ``dtype`` (release
        width, 1.5 B parameters, unless ``model_kwargs`` says otherwise), in
        the scale of the JAX package's initialisers."""
        device = resolve_device(kw.pop("device", None))
        gen = generator or torch.Generator(device).manual_seed(0)
        dtype = kw.get("dtype", torch.bfloat16)
        with torch.device("meta"):
            model = HunyuanDiT2D(**(model_kwargs or {}))
            vae = AutoencoderKL(**(vae_kwargs or {}))
        model = model.to_empty(device=device).to(dtype)
        vae = vae.to_empty(device=device).to(dtype)
        init_weights(model, gen)
        random_fill(vae, gen)
        return cls({}, model=model, vae=vae, device=device, **kw)

    @classmethod
    def from_diffusers(cls, transformer_sd: dict, vae_sd: dict, **kw):
        """From the released diffusers transformer and AutoencoderKL state
        dicts (the model's dims from ``model=`` or the release's)."""
        from motion324_tpu_torch.utils.convert import flax_to_state_dict
        from motion324_tpu_torch.utils.sd_convert import convert_sd_vae
        model = kw.pop("model", None) or HunyuanDiT2D()
        params = {"transformer": convert_hunyuan_dit_image(
                      transformer_sd, num_layers=model.num_layers),
                  "vae": flax_to_state_dict(
                      convert_sd_vae(host_arrays(vae_sd))["params"])}
        return cls(params, model=model, **kw)

    def _eps(self, x, t: float, clip, t5, cm, tm, pag_layers=()):
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        out = self.model(x, tt, clip, t5, cm, tm, pag_layers=pag_layers)
        return out[:, :self.model.in_channels]      # learned sigma dropped

    @torch.inference_mode()
    def step(self, x, t: float, a_t: float, a_prev: float, clip_c, clip_u, t5_c,
             t5_u, cm, tm, guidance: float, pag_scale: float | None = None):
        """One DDIM step with CFG (the cond and uncond branches as one batch
        of 2B); with ``pag_scale`` also PAG: the cond branch once more with
        identity self-attention in ``pag_applied_layers``,
        ``eps = e_u + g (e_c - e_u) + pag (e_c - e_p)``."""
        a_t, a_prev, g = (torch.tensor(v, dtype=torch.float32, device=x.device)
                          for v in (a_t, a_prev, guidance))
        two = lambda a, b: torch.cat([a, b], 0)
        e_c, e_u = self._eps(two(x, x), t, two(clip_c, clip_u), two(t5_c, t5_u),
                             two(cm, cm), two(tm, tm)).chunk(2, 0)
        eps = e_u + g * (e_c - e_u)
        if pag_scale is not None:
            e_p = self._eps(x, t, clip_c, t5_c, cm, tm, self.pag_applied_layers)
            eps = eps + pag_scale * (e_c - e_p)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    @torch.inference_mode()
    def __call__(self, clip_states, t5_states, *, clip_uncond=None,
                 t5_uncond=None, clip_mask=None, t5_mask=None,
                 num_steps: int = 25, guidance_scale: float = 6.0,
                 enable_pag: bool = False, pag_scale: float = 1.3,
                 seed: int = 0) -> torch.Tensor:
        """-> (B, H, W, 3) f32 images in [0, 1] on the device. Defaults are
        the reference's (25 steps, CFG 6; with ``enable_pag`` PAG at 1.3
        over blocks 16-19, one more conditional forward per step)."""
        dev = self.device
        t_ = lambda a: torch.as_tensor(a, device=dev)
        clip_c, t5_c = t_(clip_states).float(), t_(t5_states).float()
        clip_u = torch.zeros_like(clip_c) if clip_uncond is None else t_(clip_uncond)
        t5_u = torch.zeros_like(t5_c) if t5_uncond is None else t_(t5_uncond)
        cm = (torch.ones(clip_c.shape[:2], dtype=torch.int32, device=dev)
              if clip_mask is None else t_(clip_mask))
        tm = (torch.ones(t5_c.shape[:2], dtype=torch.int32, device=dev)
              if t5_mask is None else t_(t5_mask))
        b, lat = clip_c.shape[0], self.image_size // 8
        gen = torch.Generator(dev).manual_seed(seed)
        x = torch.randn((b, 4, lat, lat), generator=gen, device=dev)
        ts = np.linspace(self._num_train - 1, 0, num_steps).round().astype(np.int64)
        for i, t in enumerate(ts):
            a_prev = self._alphas[ts[i + 1]] if i + 1 < len(ts) else 1.0
            x = self.step(x, float(t), float(self._alphas[t]), float(a_prev),
                          clip_c, clip_u, t5_c, t5_u, cm, tm, guidance_scale,
                          pag_scale if enable_pag else None)
        img = self.vae.decode(x / SCALING_FACTOR)
        return ((img + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1)
