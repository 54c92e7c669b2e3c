"""ShapeVAE decoder: latent set -> occupancy logits at query points.

``post_kl`` lifts the latents, a stack of pre-norm residual self-attention
blocks (LayerNorm eps 1e-6, qkv bias) processes the set, and the
cross-attention ``geo_decoder`` scores Fourier-embedded query points against
it. The fused projections split per head, as the reference does:
``c_qkv`` into ``(B, L, H, 3 hd)`` and ``c_kv`` into ``(B, L, H, 2 hd)``,
then q | k | v within each head. Module names follow the reference
checkpoint (``transformer.resblocks.{i}.attn.c_qkv``,
``geo_decoder.cross_attn_decoder.attn.c_kv`` ...), so the decoder part of
its ``vae`` state dict loads with ``load_state_dict``.

At the release width the self-attention (512 latents, 16 heads) takes K2 and
the volume query (8 192 points x 512 latents) takes K6, both through
:func:`motion324_tpu_torch.ops.attention.multi_head_attention`.
"""

from __future__ import annotations

import torch
from torch import nn

from motion324_tpu_torch.models.transformer import LayerNorm, Linear, gelu
from motion324_tpu_torch.ops.attention import multi_head_attention
from motion324_tpu_torch.ops.embeddings import frequency_embed

__all__ = ["ShapeVAE"]


def _ln(width: int) -> LayerNorm:
    return LayerNorm(width, eps=1e-6)


class _Mlp(nn.Module):
    def __init__(self, width: int, expand: int = 4):
        super().__init__()
        self.c_fc = Linear(width, expand * width)
        self.c_proj = Linear(expand * width, width)

    def forward(self, x):
        return self.c_proj(gelu(self.c_fc(x)))


class _SelfAttn(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool,
                 attn_backend: str | None):
        super().__init__()
        self.heads = heads
        self.attn_backend = attn_backend
        self.c_qkv = Linear(width, 3 * width, bias=qkv_bias)
        self.c_proj = Linear(width, width)

    def forward(self, x):
        b, l, c = x.shape
        qkv = self.c_qkv(x).reshape(b, l, self.heads, -1)
        q, k, v = qkv.chunk(3, dim=-1)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return self.c_proj(out.reshape(b, l, c))


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = True,
                 attn_backend: str | None = None):
        super().__init__()
        self.ln_1 = _ln(width)
        self.attn = _SelfAttn(width, heads, qkv_bias, attn_backend)
        self.ln_2 = _ln(width)
        self.mlp = _Mlp(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int,
                 attn_backend: str | None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            _ResBlock(width, heads, attn_backend=attn_backend)
            for _ in range(layers))

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


class _CrossAttn(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool,
                 attn_backend: str | None):
        super().__init__()
        self.heads = heads
        self.attn_backend = attn_backend
        self.c_q = Linear(width, width, bias=qkv_bias)
        self.c_kv = Linear(width, 2 * width, bias=qkv_bias)
        self.c_proj = Linear(width, width)

    def forward(self, x, data):
        b, lq, c = x.shape
        q = self.c_q(x).reshape(b, lq, self.heads, -1)
        kv = self.c_kv(data).reshape(b, data.shape[1], self.heads, -1)
        k, v = kv.chunk(2, dim=-1)
        out = multi_head_attention(q, k, v, backend=self.attn_backend)
        return self.c_proj(out.reshape(b, lq, c))


class _CrossBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_expand: int = 4,
                 qkv_bias: bool = True, attn_backend: str | None = None):
        super().__init__()
        self.ln_1 = _ln(width)
        self.ln_2 = _ln(width)
        self.attn = _CrossAttn(width, heads, qkv_bias, attn_backend)
        self.ln_3 = _ln(width)
        self.mlp = _Mlp(width, mlp_expand)

    def forward(self, q_tokens, data):
        x = q_tokens + self.attn(self.ln_1(q_tokens), self.ln_2(data))
        return x + self.mlp(self.ln_3(x))


class _GeoDecoder(nn.Module):
    def __init__(self, in_dim: int, width: int, heads: int,
                 attn_backend: str | None):
        super().__init__()
        self.query_proj = Linear(in_dim, width)
        self.cross_attn_decoder = _CrossBlock(width, heads,
                                              attn_backend=attn_backend)
        self.ln_post = _ln(width)
        self.output_proj = Linear(width, 1)


class ShapeVAE(nn.Module):
    """Decoder-only: :meth:`decode` lifts latents, :meth:`query` scores
    points. Computes in the dtype of the parameters; logits in f32."""

    def __init__(self, num_latents: int = 512, embed_dim: int = 64,
                 width: int = 1024, heads: int = 16,
                 num_decoder_layers: int = 16, num_freqs: int = 8,
                 include_pi: bool = True, scale_factor: float = 1.0,
                 attn_backend: str | None = None):
        super().__init__()
        self.num_latents, self.embed_dim = num_latents, embed_dim
        self.num_freqs, self.include_pi = num_freqs, include_pi
        self.scale_factor = scale_factor
        self.post_kl = Linear(embed_dim, width)
        self.transformer = _Transformer(width, heads, num_decoder_layers,
                                        attn_backend)
        self.geo_decoder = _GeoDecoder(3 * (2 * num_freqs + 1), width, heads,
                                       attn_backend)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_kl.weight.dtype

    def decode(self, latents):
        """(B, num_latents, embed_dim) -> (B, num_latents, width)."""
        return self.transformer(
            self.post_kl(latents.to(self.dtype) / self.scale_factor))

    def _embed(self, points):
        # the frequencies reach 2^7 pi (about 402 rad): the multiply and
        # sin/cos run in f32, as bf16 coordinates lose a radian of phase
        emb = frequency_embed(points.float(), num_freqs=self.num_freqs,
                              include_pi=self.include_pi)
        return self.geo_decoder.query_proj(emb.to(self.dtype))

    def _head(self, q, latents):
        g = self.geo_decoder
        x = g.cross_attn_decoder(q, latents)
        return g.output_proj(g.ln_post(x))[..., 0].float()

    def query(self, points, processed_latents):
        """(B, N, 3) points -> (B, N) f32 occupancy logits."""
        return self._head(self._embed(points), processed_latents)

    def query_topk(self, points, processed_latents, topk: int = 256,
                   probe_stride: int = 100):
        """FlashVDM-style sparse query: every ``probe_stride``-th query probes
        the latents, which are ranked by summed similarity to the probes;
        the cross-attention runs against the top ``topk`` only. With ``topk``
        at least the latent count this equals :meth:`query`."""
        q = self._embed(points)
        k = min(topk, processed_latents.shape[1])
        probes = q[:, ::probe_stride]
        scores = torch.einsum("bpw,blw->bl", probes, processed_latents)
        idx = scores.topk(k, dim=-1).indices
        subset = torch.gather(processed_latents, 1,
                              idx[..., None].expand(-1, -1,
                                                    processed_latents.shape[2]))
        return self._head(q, subset)

    def forward(self, latents, points):
        return self.query(points, self.decode(latents))
