"""The two benchmarked requests in plain PyTorch, float32, from the same
inputs and weights as the system under test:

- :func:`clip_frames`: mesh + 256-frame clip -> the animated GLB's frames
  (U2Net mask, shape encoding, video encoding, point decoding, smoothing,
  the Blender remap);
- :class:`ShapeReference`: image + noise -> the conditioner tokens, the
  latents after the CFG flow-matching loop and the ShapeVAE's processed
  latent set.

TF32 is switched off while they run; ``nets.PRECISION["mode"] = "fp8"``
makes the control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.reference import mesh as M
from perfbench.reference import nets


@contextlib.contextmanager
def exact_matmul():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _gelu(cfg):
    nets.PRECISION["gelu"] = "tanh" if cfg["dtype"] == "bfloat16" else "none"


def load(build, sd, device):
    """``build()`` made without storage, then given float32 copies of the
    state dict's tensors on ``device``."""
    with torch.device("meta"):
        module = build()
    module.load_state_dict({k: (v.float() if v.is_floating_point() else v).to(device)
                            for k, v in sd.items()}, strict=True, assign=True)
    return module.eval()


def mesh_inputs(vertices, faces, uv, texture_u8, samples, device):
    """The model's mesh inputs, as the product path derives them."""
    v = M.normalize_unit_cube(vertices)
    tex = texture_u8[..., :3].astype(np.float32) / 255.0
    pts, nrm, col = M.sample_with_texture(v, faces, uv, tex, samples, seed=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(device)
    return v, dict(shape=(t(pts), t(nrm), t(col)),
                   verts=(t(v), t(M.vertex_normals(v, faces)),
                          t(M.nearest_colors(pts, col, v))))


@torch.no_grad()
def clip_frames(cfg, sd, seg_sd, mesh, clip_u8, device, frames_per_call=8,
                seg_chunk=16):
    """(T, V, 3) frames of the animated GLB for ``mesh`` (vertices, faces,
    uv, texture) and ``clip_u8`` (T, S, S, 3) uint8."""
    _gelu(cfg)
    with exact_matmul():
        base, inp = mesh_inputs(*mesh, cfg["num_shape_samples"], device)
        seg = load(nets.U2Net, seg_sd, device)
        video = torch.from_numpy(clip_u8).to(device).float() / 255.0
        masked = torch.cat([
            video[i:i + seg_chunk] * (seg(video[i:i + seg_chunk]) > 0)[..., None]
            for i in range(0, len(video), seg_chunk)])
        del seg
        model = load(lambda: nets.MotionModel(cfg), sd, device)
        model.point_dtype = getattr(torch, cfg["point_dtype"])
        mesh_feat = model.encode_shape(*inp["shape"])
        tokens = model.encode_video(masked, mesh_feat, cfg["frames"])
        trajs = model.decode_points(tokens, *inp["verts"],
                                    frames_per_call=frames_per_call)
        trajs = trajs.float().cpu().numpy()
    return M.to_blender(M.smooth(trajs)), M.to_blender(base)


def flow_sigmas(steps):
    return np.concatenate([np.linspace(0.0, 1.0, steps, dtype=np.float32),
                           np.ones(1, np.float32)])


class ShapeReference:
    """The conditioner, DiT and ShapeVAE decoder in float32, built once from
    the state dicts; :meth:`stages` recomputes one request."""

    def __init__(self, cfg, sds, device):
        self.cfg, self.device = cfg, device
        _gelu(cfg)
        with exact_matmul():
            self.cond = load(lambda: nets.DinoViT(
                cfg["cond_dim"], cfg["cond_depth"], cfg["cond_heads"], 14,
                cfg["cond_native_grid"], cfg["cond_mlp_type"]),
                sds["conditioner"], device)
            self.dit = load(lambda: nets.DiT(
                cfg["latent_dim"], cfg["cond_dim"], cfg["dit_hidden"],
                cfg["dit_heads"], cfg["dit_depth"], cfg["dit_single"]),
                sds["dit"], device)
            self.vae = load(lambda: nets.ShapeVAE(
                cfg["latent_dim"], cfg["vae_width"], cfg["vae_heads"],
                cfg["vae_layers"]), sds["vae"], device)

    @torch.no_grad()
    def stages(self, image, noise):
        """{"cond", "latents", "processed"}: ``image`` (S, S, 3) in [0, 1],
        ``noise`` (1, L, C)."""
        cfg, dev = self.cfg, self.device
        with exact_matmul():
            cond = self.cond(torch.as_tensor(image, dtype=torch.float32,
                                             device=dev)[None])
            pair = torch.cat([cond, torch.zeros_like(cond)])
            x = noise.to(dev).float()
            sig = flow_sigmas(cfg["steps"])
            for i in range(len(sig) - 1):
                t = torch.full((2,), float(sig[i]), device=dev)
                v_c, v_u = self.dit(torch.cat([x, x]), t, pair).chunk(2)
                x = x + float(sig[i + 1] - sig[i]) * (
                    v_u + cfg["guidance"] * (v_c - v_u))
            return {"cond": cond, "latents": x, "processed": self.vae.decode(x)}
