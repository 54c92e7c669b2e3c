"""MotionLatentModel: shape point cloud + video -> per-point trajectories.

Counterpart of ``motion324_tpu/models/motion_model.py`` on one device.
Token layout per frame: ``[4 special | 64 mesh | 256 image]`` = 324 tokens;
8 (global over T*324, local over 324) block pairs. Parameter names follow the
reference checkpoint (``points_transformer_blocks.{i}``,
``global_transformer_blocks.{i}``, ``shared_mlp_output.{0,1,3}``,
``image_encoder.model.*`` ...). The video position table is a computed,
non-persistent buffer.

The model computes in ``cfg.dtype`` whatever dtype its parameters are kept
in (f32 parameters under bf16 compute in training, as in the JAX recipe).
Training adds the position-embedding dropout (``train=True``, mask drawn
from an explicit ``torch.Generator``) and, with ``remat`` set, recomputes
each transformer block in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.models.dinov2 import DinoViT
from motion324_tpu_torch.models.transformer import (GELU, CrossAttentionBlock,
                                                    LayerNorm, Linear,
                                                    TransformerBlock)
from motion324_tpu_torch.ops.embeddings import (apply_point_basis,
                                                point_embed_basis,
                                                resize_pos_embed,
                                                video_pos_embed)

__all__ = ["MotionLatentModel", "init_weights"]


class _PointEmbed(nn.Module):
    def __init__(self, hidden: int, dim: int):
        super().__init__()
        self.register_buffer("basis", torch.from_numpy(point_embed_basis(hidden)),
                             persistent=False)
        self.mlp = Linear(hidden + 3, dim)

    def forward(self, pcd):
        return self.mlp(apply_point_basis(pcd, self.basis))


class _ImageEncoder(nn.Module):
    def __init__(self, model: DinoViT):
        super().__init__()
        self.model = model


class MotionLatentModel(nn.Module):
    """Predicts per-point 3D trajectories from a shape point cloud and a video.

    Inputs (as in the JAX package): shape samples ``(B, S, 3)`` x3, query
    points ``(B, N, 3)`` x3 and ``rgb_video`` ``(B, T, H, W, 3)`` in [0, 1].
    Output: ``(B, T, N, 3)`` float32 positions.
    """

    def __init__(self, cfg: ModelConfig, seed: int | None = 0):
        super().__init__()
        self.cfg = c = cfg
        self.remat = False   # recompute each block in the backward (training)
        kw = dict(head_dim=c.head_dim, use_qk_norm=c.use_qk_norm,
                  attn_backend=c.attn_backend)
        d = c.feat_dim
        self.point_embed = _PointEmbed(c.point_hidden, d)
        self.point_normal_rgb_proj = Linear(d + 6, d)
        self.learnable_tokens = nn.Parameter(torch.zeros(1, c.tokens, d))
        self.special_token_0 = nn.Parameter(torch.zeros(1, 4, d))
        self.special_token_rest = nn.Parameter(torch.zeros(1, 4, d))
        self.encoder_cross_attn = CrossAttentionBlock(d, **kw)
        self.points_transformer_blocks = nn.ModuleList(
            TransformerBlock(d, **kw) for _ in range(c.pcd_layers))
        self.image_encoder = _ImageEncoder(DinoViT(
            embed_dim=d, depth=c.dino_depth, num_heads=c.dino_heads,
            patch_size=c.patch_size, attn_backend=c.attn_backend))
        n_pairs = c.n_alternating_layers // 2
        self.global_transformer_blocks = nn.ModuleList(
            TransformerBlock(d, **kw) for _ in range(n_pairs))
        self.local_transformer_blocks = nn.ModuleList(
            TransformerBlock(d, **kw) for _ in range(n_pairs))
        self.transformer_input_layernorm = LayerNorm(d, eps=1e-5, bias=False)
        self.decoder_cross_attn = CrossAttentionBlock(d, **kw)
        self.shared_mlp_output = nn.Sequential(
            LayerNorm(d, eps=1e-5), Linear(d, d), GELU(), Linear(d, 3))
        self.register_buffer(
            "video_pos_embed",
            torch.from_numpy(video_pos_embed(c.frames, c.grid, c.grid, d)),
            persistent=False)
        if seed is not None:
            init_weights(self, torch.Generator().manual_seed(seed))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.cfg.dtype

    def _block(self, blk, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    # ------------------------------------------------------------------ #
    def _point_features(self, pcd, normals, rgbs):
        """(B, N, 3) x3 -> (B, N, C)."""
        dt = self.dtype
        emb = self.point_embed(pcd.to(dt))
        return self.point_normal_rgb_proj(
            torch.cat([emb, normals.to(dt), rgbs.to(dt)], dim=-1))

    def encode_shape(self, shape_pcd, shape_normals, shape_rgbs):
        """Shape samples -> ``(B, tokens, C)`` mesh tokens."""
        feats = self._point_features(shape_pcd, shape_normals, shape_rgbs)
        queries = self.learnable_tokens.to(self.dtype).expand(
            shape_pcd.shape[0], -1, -1)
        x = self._block(self.encoder_cross_attn, queries, feats, feats)
        for blk in self.points_transformer_blocks:
            x = self._block(blk, x)
        return x

    def encode_video(self, rgb_video, mesh_feat, train: bool = False,
                     generator: torch.Generator | None = None):
        """Video + mesh tokens -> ``(B, T, tokens, C)`` per-frame tokens.

        ``train`` applies the position-embedding dropout, its mask drawn
        from ``generator`` (on the activations' device)."""
        c = self.cfg
        b, t, h, w, _ = rgb_video.shape
        g = c.grid
        frames = rgb_video.reshape(b * t, h, w, 3)
        if (h, w) != (c.image_size, c.image_size):
            frames = F.interpolate(
                frames.permute(0, 3, 1, 2), size=(c.image_size, c.image_size),
                mode="bilinear", align_corners=False, antialias=False,
            ).permute(0, 2, 3, 1)
        with torch.no_grad():
            image_tokens = self.image_encoder.model(frames.to(self.dtype))

        if t == c.frames:
            pos = self.video_pos_embed
        else:
            pos = resize_pos_embed(self.video_pos_embed, (c.frames, g, g),
                                   (t, g, g))
        x = image_tokens.reshape(b, t * g * g, c.feat_dim) + pos.to(image_tokens.dtype)
        if train and c.drop_rate > 0:
            keep = 1.0 - c.drop_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        video_tokens = x.reshape(b, t, g * g, c.feat_dim)

        special = self.special_token_rest.to(self.dtype).expand(t, -1, -1).clone()
        special[0] = self.special_token_0[0].to(self.dtype)
        special = special[None].expand(b, -1, -1, -1)
        mesh_rep = mesh_feat[:, None].expand(-1, t, -1, -1)
        tokens = torch.cat([special, mesh_rep, video_tokens], dim=2)
        tokens = self.transformer_input_layernorm(tokens)

        l = c.frame_tokens
        x = tokens.reshape(b, t * l, c.feat_dim)
        for glob, loc in zip(self.global_transformer_blocks,
                             self.local_transformer_blocks):
            x = self._block(glob, x)
            x = self._block(loc, x.reshape(b * t, l, c.feat_dim)).reshape(
                b, t * l, c.feat_dim)
        return x.reshape(b, t, l, c.feat_dim)[:, :, 4:4 + c.tokens]

    def decode_points(self, pcd_tokens, pcd, normals, rgbs):
        """Per-frame tokens + query points -> ``(B, T, N, 3)`` float32.

        ``decode_frames_chunk`` frames (the largest divisor of T not above
        it) are folded into the batch of one decoder call.
        """
        b, t, k, d = pcd_tokens.shape
        n = pcd.shape[1]
        feats = self._point_features(pcd, normals, rgbs)
        chunk = max(1, min(self.cfg.decode_frames_chunk, t))
        while t % chunk:
            chunk -= 1
        outs = []
        for f0 in range(0, t, chunk):
            # (chunk * B, K, C), frame-major within the chunk
            tok = pcd_tokens[:, f0:f0 + chunk].transpose(0, 1).reshape(chunk * b, k, d)
            q = feats.repeat(chunk, 1, 1)
            x = self._block(self.decoder_cross_attn, q, tok, tok)
            outs.append(self.shared_mlp_output(x).reshape(chunk, b, n, 3))
        return torch.cat(outs, dim=0).transpose(0, 1).float()

    def forward(self, sample: dict, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        mesh_feat = self.encode_shape(sample["ref_shape_pcd"],
                                      sample["ref_shape_normals"],
                                      sample["ref_shape_rgbs"])
        tokens = self.encode_video(sample["rgb_video"], mesh_feat, train=train,
                                   generator=generator)
        return self.decode_points(tokens, sample["ref_pcd"],
                                  sample["ref_normal"], sample["ref_rgb"])


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initialisers: Linear and
    Conv kernels lecun-normal (std 1/sqrt(fan_in)), biases 0, norm scales 1,
    learnable/special tokens N(0, 1), DINO position table N(0, 0.02), CLS 0,
    LayerScale 1e-5. Draws in ``named_parameters`` order."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("learnable_tokens", "special_token_0", "special_token_rest"):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        elif leaf == "cls_token" or leaf == "bias":
            p.zero_()
        elif leaf == "gamma":
            p.fill_(1e-5)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
