"""Plain PyTorch reference of Hunyuan3D-2.1's shape half, in float32: the
DINOv2-large conditioner (``[CLS | patch]`` tokens), the 21-block DiT with
U-ViT skips and a mixture of experts (``hunyuan3d-dit-v2-1``,
``HunYuanDiTPlain``), and the ShapeVAE decoder of ``nets``.

Parameter names are the system's, so one state dict loads here and into it.
No kernel, no grouping, no batching tricks: attention is ``nets.attention``
(the softmax of the full logits), and the mixture of experts is a loop over
the experts, each applied to the tokens that picked it (a mask). The
experts' weights are the system's banks: one tensor per projection for
the routed experts and, last, the shared one.

:class:`Shape21Reference` recomputes one request: image -> condition
tokens -> the CFG flow-matching Euler loop -> the ShapeVAE's processed
latent set, and the DiT's first velocity of the conditional half.
``nets.PRECISION["mode"] = "fp8"`` makes the control, as for ``nets``.

Details this reference takes as the system does, where the release is not
at hand to confirm them (the configuration lists them under ``assumed``):
the timestep enters as one token ``W2 GELU(W1 sincos(1000 sigma) + b1) +
b2`` (width ``hidden``, cos first, max period 10 000); a skip block applies
its linear layer, then its LayerNorm; no timestep modulation inside the
blocks; exact GELU; the router's top-2 weights are not renormalised, ties
to the lower expert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import nets
from perfbench.reference.pipelines import _gelu, exact_matmul, flow_sigmas, load


def _lin(x, w, b=None):
    return F.linear(nets.lowp(x), nets.lowp(w), b)


class _Attn(nn.Module):
    def __init__(self, dim, heads, ctx_dim):
        super().__init__()
        self.heads = heads
        self.to_q = nets.Linear(dim, dim, bias=False)
        self.to_k = nets.Linear(ctx_dim, dim, bias=False)
        self.to_v = nets.Linear(ctx_dim, dim, bias=False)
        self.q_norm = nets.RMSNorm(dim // heads, 1e-6)
        self.k_norm = nets.RMSNorm(dim // heads, 1e-6)
        self.out_proj = nets.Linear(dim, dim)

    def forward(self, x, ctx):
        b, l, c = x.shape
        q = self.to_q(x).view(b, l, self.heads, -1)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, -1)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, -1)
        a = nets.attention(self.q_norm(q), self.k_norm(k), v)
        return self.out_proj(a.reshape(b, l, c))


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = nets.Linear(dim, hidden), nets.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Bank(nn.Module):
    def __init__(self, n, dim_in, dim_out):
        super().__init__()
        self.n, self.dim_out = n, dim_out
        self.weight = nn.Parameter(torch.empty(n * dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(n * dim_out))

    def expert(self, x, e):
        rows = slice(e * self.dim_out, (e + 1) * self.dim_out)
        return _lin(x, self.weight[rows], self.bias[rows])


class _Experts(nn.Module):
    def __init__(self, n, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = _Bank(n, dim, hidden), _Bank(n, hidden, dim)

    def ffn(self, x, e):
        return self.fc2.expert(F.gelu(self.fc1.expert(x, e)), e)


class MoE(nn.Module):
    """``sum over the top-2 experts of p_e FFN_e(x) + FFN_shared(x)``."""

    TOP_K = 2

    def __init__(self, dim, hidden, experts):
        super().__init__()
        self.n = experts
        self.gate = nets.Linear(dim, experts, bias=False)
        self.experts = _Experts(experts + 1, dim, hidden)

    def forward(self, x):
        shared = self.experts.ffn(x, self.n)
        if x.device.type == "meta":
            # no data, so no routing: the FLOPs of TOP_K routed FFNs a token
            out = shared
            for e in range(self.TOP_K):
                out = out + self.experts.ffn(x, e)
            return out
        p = torch.softmax(self.gate(x).float(), dim=-1)
        # descending, a stable sort: equal weights keep the lower expert first
        top = torch.sort(p, dim=-1, descending=True,
                         stable=True).indices[..., :self.TOP_K]
        out = shared.clone()
        for e in range(self.n):
            mask = (top == e).any(dim=-1)
            if mask.any():
                out[mask] += p[mask][:, e:e + 1] * self.experts.ffn(x[mask], e)
        return out


class Block(nn.Module):
    def __init__(self, dim, heads, ctx_dim, skip, moe, experts):
        super().__init__()
        if skip:
            self.skip_linear = nets.Linear(2 * dim, dim)
            self.skip_norm = nets.layer_norm(dim, 1e-6)
        self.norm1 = nets.layer_norm(dim, 1e-6)
        self.attn1 = _Attn(dim, heads, dim)
        self.norm2 = nets.layer_norm(dim, 1e-6)
        self.attn2 = _Attn(dim, heads, ctx_dim)
        self.norm3 = nets.layer_norm(dim, 1e-6)
        if moe:
            self.moe = MoE(dim, 4 * dim, experts)
        else:
            self.mlp = _Mlp(dim, 4 * dim)

    def forward(self, x, cond, skip):
        if skip is not None:
            x = self.skip_norm(self.skip_linear(torch.cat([skip, x], -1)))
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(self.norm2(x), cond)
        return x + (self.moe if hasattr(self, "moe") else self.mlp)(self.norm3(x))


class _TEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.mlp = nn.Sequential(nets.Linear(dim, 4 * dim), nn.GELU(),
                                 nets.Linear(4 * dim, dim))


class DiT21(nn.Module):
    """x (B, L, C), sigma (B,), cond (B, Lc, Cc) -> velocity (B, L, C)."""

    def __init__(self, latent_dim, cond_dim, hidden, heads, depth, moe_layers,
                 experts):
        super().__init__()
        self.depth, self.hidden = depth, hidden
        self.x_embedder = nets.Linear(latent_dim, hidden)
        self.t_embedder = _TEmbed(hidden)
        self.blocks = nn.ModuleList(
            Block(hidden, heads, cond_dim, l > depth // 2,
                  depth - l <= moe_layers, experts) for l in range(depth))
        self.final_layer = nn.Module()
        self.final_layer.norm_final = nets.layer_norm(hidden, 1e-6)
        self.final_layer.linear = nets.Linear(hidden, latent_dim)

    def forward(self, x, t, cond):
        t_tok = self.t_embedder.mlp(nets.timestep_embedding(t, self.hidden,
                                                            max_period=10000.0))
        x = torch.cat([t_tok[:, None], self.x_embedder(x)], 1)
        stack = []
        for l, blk in enumerate(self.blocks):
            x = blk(x, cond, stack.pop() if l > self.depth // 2 else None)
            if l < self.depth // 2:
                stack.append(x)
        f = self.final_layer
        return f.linear(f.norm_final(x[:, 1:]))


class DinoViTCls(nets.DinoViT):
    """``nets.DinoViT`` returning ``[CLS | patch]`` tokens."""

    def forward(self, images):
        b, h, _, _ = images.shape
        g = h // self.patch
        mean = images.new_tensor(nets.IMAGENET_MEAN)
        std = images.new_tensor(nets.IMAGENET_STD)
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
        return self.norm(x)


def model_makers(cfg: dict) -> dict:
    """{"conditioner", "dit", "vae"}: a constructor of each module."""
    return {
        "conditioner": lambda: DinoViTCls(
            cfg["cond_dim"], cfg["cond_depth"], cfg["cond_heads"], 14,
            cfg["cond_native_grid"], cfg["cond_mlp_type"]),
        "dit": lambda: DiT21(cfg["latent_dim"], cfg["cond_dim"], cfg["dit_hidden"],
                             cfg["dit_heads"], cfg["dit_depth"], cfg["dit_moe_layers"],
                             cfg["dit_experts"]),
        "vae": lambda: nets.ShapeVAE(cfg["latent_dim"], cfg["vae_width"],
                                     cfg["vae_heads"], cfg["vae_layers"]),
    }


class Shape21Reference:
    """The three models in float32, built once from the state dicts;
    :meth:`stages` recomputes one request."""

    def __init__(self, cfg, sds, device):
        self.cfg, self.device = cfg, device
        _gelu(cfg)
        makers = model_makers(cfg)
        with exact_matmul():
            self.cond, self.dit, self.vae = (load(makers[n], sds[n], device)
                                             for n in ("conditioner", "dit", "vae"))

    @torch.no_grad()
    def stages(self, image, noise):
        """{"cond", "step1", "latents", "processed"}: ``image`` (S, S, 3) in
        [0, 1], ``noise`` (1, L, C); ``step1`` the DiT's velocity of the
        conditional half at the first step."""
        cfg, dev = self.cfg, self.device
        with exact_matmul():
            cond = self.cond(torch.as_tensor(image, dtype=torch.float32,
                                             device=dev)[None])
            pair = torch.cat([cond, torch.zeros_like(cond)])
            x = noise.to(dev).float()
            sig = flow_sigmas(cfg["steps"])
            step1 = None
            for i in range(len(sig) - 1):
                t = torch.full((2,), float(sig[i]), device=dev)
                v_c, v_u = self.dit(torch.cat([x, x]), t, pair).chunk(2)
                if step1 is None:
                    step1 = v_c
                x = x + float(sig[i + 1] - sig[i]) * (
                    v_u + cfg["guidance"] * (v_c - v_u))
            return {"cond": cond, "step1": step1, "latents": x,
                    "processed": self.vae.decode(x)}
