"""Plain PyTorch reference of the two benchmarked models, in float32.

The motion model (point cloud + video -> per-point trajectories, with its
DINOv2 ViT-B/14 and the U2Net that masks the frames) and Hunyuan3D-2's shape
half (the DINOv2-giant conditioner, the flow-matching DiT and the ShapeVAE's
latent-set transformer). Module and parameter names are those of the
released checkpoints, so one state dict loads here and into the system
under test. No kernel, no cache, no batching tricks: attention is the
softmax of the full logits, taken in blocks of queries so that 82 944
tokens fit on one card.

Departures from the published description, each the system's own bf16
rule, kept so that both sides compute the same function:

- GELU is the tanh form (the system's rule under bf16; the DiT uses it in
  every precision); ``PRECISION["gelu"]`` gives the exact form for a
  float32 configuration.
- The point Fourier features multiply the points by their basis after both
  are rounded to the compute dtype (``point_dtype``, bf16 as configured):
  the published model and the system both run that product in the compute
  dtype, and at frequencies up to 128 pi its rounding is part of the
  features, not noise on them.

``PRECISION["mode"]`` selects the arithmetic of every matrix product
(linear layers, convolutions, attention's q, k, v and weights): ``"f32"``
is the reference; ``"fp8"`` rounds each operand to float8 e4m3 with a
per-tensor scale first, the control that a lower precision must fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# "mode": the arithmetic of the matrix products; "gelu": the GELU of the
# motion model, DINOv2 and the ShapeVAE ("tanh" as the system computes it
# in bf16, "none" for the exact erf form it uses in float32)
PRECISION = {"mode": "f32", "gelu": "tanh"}
ATTN_BLOCK_BYTES = 2 ** 31      # logits held at once by :func:`attention`


def lowp(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the current precision mode rounds a matrix operand."""
    if PRECISION["mode"] != "fp8" or x.numel() == 0:
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale)


def gelu(x):
    return F.gelu(x, approximate=PRECISION["gelu"])


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(lowp(x), lowp(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(lowp(x), lowp(self.weight), self.bias, self.stride,
                        self.padding, self.dilation)


def layer_norm(dim, eps, bias=True):
    return nn.LayerNorm(dim, eps=eps, bias=bias)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-5, name="weight"):
        super().__init__()
        self.eps, self._name = eps, name
        setattr(self, name, nn.Parameter(torch.ones(dim)))

    def forward(self, x):
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
                * getattr(self, self._name))


def attention(q, k, v, scale=None):
    """softmax(q k^T * scale) v over ``(B, S, H, D)``, in blocks of batch
    and query rows."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q, k, v = lowp(q), lowp(k), lowp(v)
    out = torch.empty(b, sq, h, v.shape[-1], dtype=q.dtype, device=q.device)
    per_row = h * sk * 4
    rows = max(1, ATTN_BLOCK_BYTES // per_row)
    nb = max(1, min(b, rows // sq))
    qb = sq if nb > 1 or rows >= sq else rows
    for b0 in range(0, b, nb):
        kk, vv = k[b0:b0 + nb], v[b0:b0 + nb]
        for s0 in range(0, sq, qb):
            logits = torch.einsum("bqhd,bkhd->bhqk", q[b0:b0 + nb, s0:s0 + qb],
                                  kk) * scale
            p = lowp(torch.softmax(logits, dim=-1))
            out[b0:b0 + nb, s0:s0 + qb] = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return out


# --------------------------------------------------------------------- #
# motion model
# --------------------------------------------------------------------- #
class MLP(nn.Module):
    def __init__(self, dim, ratio=4):
        super().__init__()
        self.mlp = nn.Sequential(Linear(dim, dim * ratio, bias=False),
                                 nn.Identity(),
                                 Linear(dim * ratio, dim, bias=False))

    def forward(self, x):
        return self.mlp[2](gelu(self.mlp[0](x)))


class SelfAttention(nn.Module):
    def __init__(self, dim, head_dim):
        super().__init__()
        self.hd = head_dim
        self.to_qkv = Linear(dim, 3 * dim, bias=False)
        self.fc = Linear(dim, dim, bias=False)
        self.q_norm, self.k_norm = RMSNorm(head_dim), RMSNorm(head_dim)

    def forward(self, x):
        b, l, c = x.shape
        q, k, v = (t.view(b, l, c // self.hd, self.hd)
                   for t in self.to_qkv(x).split(c, dim=-1))
        out = attention(self.q_norm(q), self.k_norm(k), v)
        return self.fc(out.reshape(b, l, c))


class CrossAttention(nn.Module):
    def __init__(self, dim, head_dim):
        super().__init__()
        self.hd = head_dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.fc = Linear(dim, dim, bias=False)
        self.q_norm, self.k_norm = RMSNorm(head_dim), RMSNorm(head_dim)

    def forward(self, q_in, kv):
        b, lq, c = q_in.shape
        lk, nh = kv.shape[1], c // self.hd
        q = self.q_norm(self.to_q(q_in).view(b, lq, nh, self.hd))
        k = self.k_norm(self.to_k(kv).view(b, lk, nh, self.hd))
        v = self.to_v(kv).view(b, lk, nh, self.hd)
        return self.fc(attention(q, k, v).reshape(b, lq, c))


class Block(nn.Module):
    def __init__(self, dim, head_dim):
        super().__init__()
        self.norm1 = layer_norm(dim, 1e-5, bias=False)
        self.attn = SelfAttention(dim, head_dim)
        self.norm2 = layer_norm(dim, 1e-5, bias=False)
        self.mlp = MLP(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CrossBlock(nn.Module):
    def __init__(self, dim, head_dim):
        super().__init__()
        self.norm_q = layer_norm(dim, 1e-5, bias=False)
        self.norm_kv = layer_norm(dim, 1e-5, bias=False)
        self.attn = CrossAttention(dim, head_dim)
        self.norm2 = layer_norm(dim, 1e-5, bias=False)
        self.mlp = MLP(dim)

    def forward(self, q, kv):
        x = q + self.attn(self.norm_q(q), self.norm_kv(kv))
        return x + self.mlp(self.norm2(x))


# DINOv2 (torch-hub names)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _DinoAttn(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, l, c = x.shape
        q, k, v = (t.view(b, l, self.heads, c // self.heads)
                   for t in self.qkv(x).split(c, dim=-1))
        return self.proj(attention(q, k, v).reshape(b, l, c))


class _LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class _DinoMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class _SwiGLU(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.w12, self.w3 = Linear(dim, 2 * hidden), Linear(hidden, dim)

    def forward(self, x):
        h1, h2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(h1) * h2)


def swiglu_hidden(dim, ratio=4):
    return ((int(dim * ratio * 2 / 3) + 7) // 8) * 8


class _DinoBlock(nn.Module):
    def __init__(self, dim, heads, mlp_type):
        super().__init__()
        self.norm1 = layer_norm(dim, 1e-6)
        self.attn = _DinoAttn(dim, heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = layer_norm(dim, 1e-6)
        self.mlp = (_SwiGLU(dim, swiglu_hidden(dim)) if mlp_type == "swiglu"
                    else _DinoMlp(dim, 4 * dim))
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.gamma
        return x + self.mlp(self.norm2(x)) * self.ls2.gamma


class _PatchEmbed(nn.Module):
    def __init__(self, dim, patch):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class DinoViT(nn.Module):
    """``(B, H, W, 3)`` in [0, 1] -> patch tokens (CLS dropped)."""

    def __init__(self, dim, depth, heads, patch=14, native_grid=37,
                 mlp_type="mlp"):
        super().__init__()
        self.patch, self.native_grid = patch, native_grid
        self.patch_embed = _PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + native_grid ** 2, dim))
        self.blocks = nn.ModuleList(_DinoBlock(dim, heads, mlp_type)
                                    for _ in range(depth))
        self.norm = layer_norm(dim, 1e-6)

    def forward(self, images):
        b, h, w, _ = images.shape
        g = h // self.patch
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        x = self.patch_embed.proj(((images - mean) / std).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed[:, 1:]
        n, c = self.native_grid, pos.shape[-1]
        if g != n:
            pos = F.interpolate(pos.reshape(1, n, n, c).permute(0, 3, 1, 2),
                                size=(g, g), mode="bicubic", antialias=True,
                                align_corners=False)
            pos = pos.permute(0, 2, 3, 1).reshape(1, g * g, c)
        x = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1),
                       x + pos], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:]


def point_basis(hidden):
    n = hidden // 6
    e = (2.0 ** np.arange(n, dtype=np.float32)) * np.pi
    basis = np.zeros((3, 3 * n), np.float32)
    for i in range(3):
        basis[i, i * n:(i + 1) * n] = e
    return torch.from_numpy(basis)


def video_pos_table(t, g, dim):
    """The (1, T g g, dim) Fourier table of the (T, g, g) token grid."""
    def axis(n):
        a = np.arange(n, dtype=np.float32)
        return 2 * (a / (n - 1)) - 1 if n > 1 else np.zeros(1, np.float32)
    tt, hh, ww = np.meshgrid(axis(t), axis(g), axis(g), indexing="ij")
    ang = np.stack([tt, hh, ww], -1)[..., None] * (
        2.0 ** np.linspace(0.0, 7.0, dim // 6)).astype(np.float32)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.reshape(1, t * g * g, dim).astype(np.float32))


class _PointEmbed(nn.Module):
    def __init__(self, hidden, dim):
        super().__init__()
        self.mlp = Linear(hidden + 3, dim)


class _ImageEncoder(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model


class MotionModel(nn.Module):
    """The motion model of ``configs/dyscene.yaml``: ``cfg`` holds
    feat_dim, tokens, pcd_layers, n_alternating_layers, head_dim,
    image_size, patch_size, dino_depth, dino_heads, point_hidden."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, hd = cfg["feat_dim"], cfg["head_dim"]
        self.cfg = cfg
        self.point_embed = _PointEmbed(cfg["point_hidden"], d)
        self.point_normal_rgb_proj = Linear(d + 6, d)
        self.learnable_tokens = nn.Parameter(torch.zeros(1, cfg["tokens"], d))
        self.special_token_0 = nn.Parameter(torch.zeros(1, 4, d))
        self.special_token_rest = nn.Parameter(torch.zeros(1, 4, d))
        self.encoder_cross_attn = CrossBlock(d, hd)
        self.points_transformer_blocks = nn.ModuleList(
            Block(d, hd) for _ in range(cfg["pcd_layers"]))
        self.image_encoder = _ImageEncoder(DinoViT(
            d, cfg["dino_depth"], cfg["dino_heads"], cfg["patch_size"]))
        pairs = cfg["n_alternating_layers"] // 2
        self.global_transformer_blocks = nn.ModuleList(Block(d, hd)
                                                       for _ in range(pairs))
        self.local_transformer_blocks = nn.ModuleList(Block(d, hd)
                                                      for _ in range(pairs))
        self.transformer_input_layernorm = layer_norm(d, 1e-5, bias=False)
        self.decoder_cross_attn = CrossBlock(d, hd)
        self.shared_mlp_output = nn.Sequential(
            layer_norm(d, 1e-5), Linear(d, d), nn.Identity(), Linear(d, 3))
        self.point_dtype = torch.float32

    def point_features(self, pcd, normals, rgbs):
        """(B, N, 3) x3 -> (B, N, C)."""
        dt = self.point_dtype
        basis = point_basis(self.cfg["point_hidden"]).to(pcd.device)
        proj = (pcd.to(dt) @ basis.to(dt)).float()
        p = pcd.to(dt).float()
        emb = self.point_embed.mlp(torch.cat([proj.sin(), proj.cos(), p], -1))
        return self.point_normal_rgb_proj(torch.cat([emb, normals, rgbs], -1))

    def encode_shape(self, pcd, normals, rgbs):
        feats = self.point_features(pcd, normals, rgbs)
        x = self.encoder_cross_attn(
            self.learnable_tokens.expand(pcd.shape[0], -1, -1), feats)
        for blk in self.points_transformer_blocks:
            x = blk(x)
        return x

    def encode_video(self, video, mesh_feat, frames_native, dino_chunk=64):
        """``video`` (T, S, S, 3) in [0, 1], masked -> (T, tokens, C)."""
        c = self.cfg
        t, d = video.shape[0], c["feat_dim"]
        g = c["image_size"] // c["patch_size"]
        img = torch.cat([self.image_encoder.model(video[i:i + dino_chunk])
                         for i in range(0, t, dino_chunk)])
        pos = video_pos_table(frames_native, g, d).to(video.device)
        if t != frames_native:
            grid = pos.reshape(1, frames_native, g, g, d).permute(0, 4, 1, 2, 3)
            pos = F.interpolate(grid, size=(t, g, g), mode="trilinear",
                                align_corners=False)
            pos = pos.permute(0, 2, 3, 4, 1).reshape(1, t * g * g, d)
        x = img.reshape(1, t * g * g, d) + pos
        special = self.special_token_rest.expand(t, -1, -1).clone()
        special[0] = self.special_token_0[0]
        tokens = torch.cat([special, mesh_feat.expand(t, -1, -1),
                            x.reshape(t, g * g, d)], dim=1)
        tokens = self.transformer_input_layernorm(tokens)
        ft = tokens.shape[1]
        x = tokens.reshape(1, t * ft, d)
        for glob, loc in zip(self.global_transformer_blocks,
                             self.local_transformer_blocks):
            x = glob(x)
            x = loc(x.reshape(t, ft, d)).reshape(1, t * ft, d)
        return x.reshape(t, ft, d)[:, 4:4 + c["tokens"]]

    def decode_points(self, tokens, pcd, normals, rgbs, frames_per_call=8):
        """(T, tokens, C) + (1, N, 3) x3 -> (T, N, 3)."""
        feats = self.point_features(pcd, normals, rgbs)
        outs = []
        for f0 in range(0, tokens.shape[0], frames_per_call):
            tok = tokens[f0:f0 + frames_per_call]
            x = self.decoder_cross_attn(feats.expand(tok.shape[0], -1, -1), tok)
            m = self.shared_mlp_output
            outs.append(m[3](gelu(m[1](m[0](x)))))
        return torch.cat(outs)


# --------------------------------------------------------------------- #
# U2Net (public u2net.pth names; inference-mode BatchNorm)
# --------------------------------------------------------------------- #
class _BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, 1e-5)


class _REBN(nn.Module):
    def __init__(self, cin, cout, dil=1):
        super().__init__()
        self.conv_s1 = Conv2d(cin, cout, 3, padding=dil, dilation=dil)
        self.bn_s1 = _BN(cout)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _down(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up(x, like):
    if x.shape[2:] == like.shape[2:]:
        return x
    return F.interpolate(x, size=like.shape[2:], mode="bilinear",
                         align_corners=False)


class RSU(nn.Module):
    def __init__(self, height, cin, mid, out):
        super().__init__()
        self.height = height
        self.rebnconvin = _REBN(cin, out)
        self.rebnconv1 = _REBN(out, mid)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", _REBN(mid, mid))
        setattr(self, f"rebnconv{height}", _REBN(mid, mid, 2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", _REBN(2 * mid, mid))
        self.rebnconv1d = _REBN(2 * mid, out)

    def forward(self, x):
        xin = self.rebnconvin(x)
        h = self.rebnconv1(xin)
        encs = [h]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(_down(h))
            encs.append(h)
        h = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 0, -1):
            e = encs[i - 1]
            h = getattr(self, f"rebnconv{i}d")(torch.cat([_up(h, e), e], 1))
        return h + xin


class RSU4F(nn.Module):
    def __init__(self, cin, mid, out):
        super().__init__()
        self.rebnconvin = _REBN(cin, out)
        self.rebnconv1 = _REBN(out, mid, 1)
        self.rebnconv2 = _REBN(mid, mid, 2)
        self.rebnconv3 = _REBN(mid, mid, 4)
        self.rebnconv4 = _REBN(mid, mid, 8)
        self.rebnconv3d = _REBN(2 * mid, mid, 4)
        self.rebnconv2d = _REBN(2 * mid, mid, 2)
        self.rebnconv1d = _REBN(2 * mid, out, 1)

    def forward(self, x):
        xin = self.rebnconvin(x)
        h1 = self.rebnconv1(xin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        return self.rebnconv1d(torch.cat([d2, h1], 1)) + xin


class U2Net(nn.Module):
    """``(B, H, W, 3)`` in [0, 1] -> the fused logit ``(B, H, W)``."""

    def __init__(self):
        super().__init__()
        self.stage1 = RSU(7, 3, 32, 64)
        self.stage2 = RSU(6, 64, 32, 128)
        self.stage3 = RSU(5, 128, 64, 256)
        self.stage4 = RSU(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSU(4, 1024, 128, 256)
        self.stage3d = RSU(5, 512, 64, 128)
        self.stage2d = RSU(6, 256, 32, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i, c in enumerate((64, 64, 128, 256, 512, 512), 1):
            setattr(self, f"side{i}", Conv2d(c, 1, 3, padding=1))
        self.outconv = Conv2d(6, 1, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        s1 = self.stage1(x)
        s2 = self.stage2(_down(s1))
        s3 = self.stage3(_down(s2))
        s4 = self.stage4(_down(s3))
        s5 = self.stage5(_down(s4))
        s6 = self.stage6(_down(s5))
        cat = lambda a, b: torch.cat([_up(a, b), b], 1)
        d5 = self.stage5d(cat(s6, s5))
        d4 = self.stage4d(cat(d5, s4))
        d3 = self.stage3d(cat(d4, s3))
        d2 = self.stage2d(cat(d3, s2))
        d1 = self.stage1d(cat(d2, s1))
        sides = [_up(getattr(self, f"side{i}")(f), x)
                 for i, f in enumerate((d1, d2, d3, d4, d5, s6), 1)]
        return self.outconv(torch.cat(sides, 1))[:, 0]


# --------------------------------------------------------------------- #
# Hunyuan3D-2 shape: DiT and ShapeVAE decoder (released names)
# --------------------------------------------------------------------- #
def timestep_embedding(t, dim, max_period=1000.0, time_factor=1000.0):
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class _MLPEmbedder(nn.Module):
    def __init__(self, i, h):
        super().__init__()
        self.in_layer, self.out_layer = Linear(i, h), Linear(h, h)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class _Mod(nn.Module):
    def __init__(self, dim, double):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Linear(dim, self.mult * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.mult, dim=-1)


class _QKNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.query_norm = RMSNorm(dim, 1e-6, "scale")
        self.key_norm = RMSNorm(dim, 1e-6, "scale")


class _DitAttn(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.norm = _QKNorm(dim // heads)
        self.proj = Linear(dim, dim)

    def qkv_heads(self, x):
        b, l, c = x.shape
        q, k, v = (t.reshape(b, l, self.heads, c // self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        return self.norm.query_norm(q), self.norm.key_norm(k), v


def _dit_mlp(dim, hidden):
    return nn.Sequential(Linear(dim, hidden), nn.Identity(), Linear(hidden, dim))


def _run_mlp(seq, x):
    return seq[2](gelu_tanh(seq[0](x)))


class DoubleBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.img_mod, self.txt_mod = _Mod(dim, True), _Mod(dim, True)
        self.img_attn, self.txt_attn = _DitAttn(dim, heads), _DitAttn(dim, heads)
        self.img_mlp, self.txt_mlp = _dit_mlp(dim, 4 * dim), _dit_mlp(dim, 4 * dim)

    def forward(self, img, txt, vec):
        i1s, i1c, i1g, i2s, i2c, i2g = self.img_mod(vec)
        t1s, t1c, t1g, t2s, t2c, t2g = self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_heads((1 + i1c) * _ln(img) + i1s)
        tq, tk, tv = self.txt_attn.qkv_heads((1 + t1c) * _ln(txt) + t1s)
        a = attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                      torch.cat([tv, iv], 1))
        a = a.reshape(*a.shape[:2], -1)
        lt = txt.shape[1]
        img = img + i1g * self.img_attn.proj(a[:, lt:])
        img = img + i2g * _run_mlp(self.img_mlp, (1 + i2c) * _ln(img) + i2s)
        txt = txt + t1g * self.txt_attn.proj(a[:, :lt])
        txt = txt + t2g * _run_mlp(self.txt_mlp, (1 + t2c) * _ln(txt) + t2s)
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.modulation = _Mod(dim, False)
        self.linear1 = Linear(dim, 7 * dim)
        self.linear2 = Linear(5 * dim, dim)
        self.norm = _QKNorm(dim // heads)

    def forward(self, x, vec):
        b, l, _ = x.shape
        shift, scale, gate = self.modulation(vec)
        qkv, mlp = self.linear1((1 + scale) * _ln(x) + shift).split(
            [3 * self.dim, 4 * self.dim], dim=-1)
        q, k, v = (t.reshape(b, l, self.heads, -1) for t in qkv.chunk(3, -1))
        a = attention(self.norm.query_norm(q), self.norm.key_norm(k), v)
        return x + gate * self.linear2(torch.cat([a.reshape(b, l, self.dim),
                                                  gelu_tanh(mlp)], -1))


class _LastLayer(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 2 * dim))
        self.linear = Linear(dim, out)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec)[:, None, :].chunk(2, dim=-1)
        return self.linear((1 + scale) * _ln(x) + shift)


class DiT(nn.Module):
    """x (B, L, C), t (B,), cond (B, Lc, Cc) -> velocity (B, L, C)."""

    def __init__(self, latent_dim, cond_dim, hidden, heads, depth, single):
        super().__init__()
        self.latent_in = Linear(latent_dim, hidden)
        self.time_in = _MLPEmbedder(256, hidden)
        self.cond_in = Linear(cond_dim, hidden)
        self.double_blocks = nn.ModuleList(DoubleBlock(hidden, heads)
                                           for _ in range(depth))
        self.single_blocks = nn.ModuleList(SingleBlock(hidden, heads)
                                           for _ in range(single))
        self.final_layer = _LastLayer(hidden, latent_dim)

    def forward(self, x, t, cond):
        lat = self.latent_in(x)
        vec = self.time_in(timestep_embedding(t, 256))
        cond = self.cond_in(cond)
        for blk in self.double_blocks:
            lat, cond = blk(lat, cond, vec)
        merged = torch.cat([cond, lat], 1)
        for blk in self.single_blocks:
            merged = blk(merged, vec)
        return self.final_layer(merged[:, cond.shape[1]:], vec)


class _VaeMlp(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.c_fc, self.c_proj = Linear(w, 4 * w), Linear(4 * w, w)

    def forward(self, x):
        return self.c_proj(gelu(self.c_fc(x)))


class _VaeAttn(nn.Module):
    def __init__(self, w, heads):
        super().__init__()
        self.heads = heads
        self.c_qkv, self.c_proj = Linear(w, 3 * w), Linear(w, w)

    def forward(self, x):
        b, l, c = x.shape
        q, k, v = self.c_qkv(x).reshape(b, l, self.heads, -1).chunk(3, dim=-1)
        return self.c_proj(attention(q, k, v).reshape(b, l, c))


class _ResBlock(nn.Module):
    def __init__(self, w, heads):
        super().__init__()
        self.ln_1, self.ln_2 = layer_norm(w, 1e-6), layer_norm(w, 1e-6)
        self.attn, self.mlp = _VaeAttn(w, heads), _VaeMlp(w)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _VaeTransformer(nn.Module):
    def __init__(self, w, heads, layers):
        super().__init__()
        self.resblocks = nn.ModuleList(_ResBlock(w, heads) for _ in range(layers))


class _CrossAttnV(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.c_q, self.c_kv, self.c_proj = Linear(w, w), Linear(w, 2 * w), Linear(w, w)


class _CrossBlockV(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.ln_1, self.ln_2, self.ln_3 = (layer_norm(w, 1e-6) for _ in range(3))
        self.attn, self.mlp = _CrossAttnV(w), _VaeMlp(w)


class _GeoDecoder(nn.Module):
    def __init__(self, in_dim, w):
        super().__init__()
        self.query_proj = Linear(in_dim, w)
        self.cross_attn_decoder = _CrossBlockV(w)
        self.ln_post = layer_norm(w, 1e-6)
        self.output_proj = Linear(w, 1)


class ShapeVAE(nn.Module):
    """The decoder of the released ShapeVAE; :meth:`decode` lifts latents
    (the geometry decoder is held for the weights' names only)."""

    def __init__(self, latent_dim, width, heads, layers, num_freqs=8):
        super().__init__()
        self.num_freqs = num_freqs
        self.post_kl = Linear(latent_dim, width)
        self.transformer = _VaeTransformer(width, heads, layers)
        self.geo_decoder = _GeoDecoder(3 * (2 * num_freqs + 1), width)

    def decode(self, latents):
        x = self.post_kl(latents)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x
