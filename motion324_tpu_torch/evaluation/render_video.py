"""Animated mesh -> video frames through the port's rasterizer
(counterpart of ``motion324_tpu/evaluation/render_video.py``).

Each frame is rasterized by :func:`~motion324_tpu_torch.ops.rasterizer.
rasterize` (K8 on a CUDA device, its plain version on the CPU) and shaded
by barycentric interpolation: textured when the mesh carries a UV atlas,
vertex-coloured or Lambertian otherwise, under a headlight, composited over
a white background. The clip is first normalised into a unit box around the
origin, as the reference's Blender scene does. This is how the system
checks its own output: the animated result rendered and scored against the
input video.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.camera import (orthographic, perspective,
                                                view_matrix)
from motion324_tpu_torch.ops.rasterizer import interpolate, rasterize

__all__ = ["render_animated_mesh", "render_animated_glb"]


def _vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, unit length (0 where they vanish)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_add(0, faces[:, i], fn)
    norm = vn.norm(dim=-1, keepdim=True)
    return vn / torch.where(norm == 0, torch.ones_like(norm), norm)


def _sample_texture(texture: torch.Tensor, uvi: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sample; ``uvi`` (H, W, 2) in [0, 1], V-down rows."""
    th, tw = texture.shape[:2]
    px = uvi[..., 0].clamp(0.0, 1.0) * (tw - 1)
    py = uvi[..., 1].clamp(0.0, 1.0) * (th - 1)
    x0 = px.floor().long().clamp(0, tw - 1)
    y0 = py.floor().long().clamp(0, th - 1)
    x1 = (x0 + 1).clamp(max=tw - 1)
    y1 = (y0 + 1).clamp(max=th - 1)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    c00, c01 = texture[y0, x0], texture[y0, x1]
    c10, c11 = texture[y1, x0], texture[y1, x1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _render_frame(verts, faces, mvp, light, resolution: int, mode: str,
                  uv, texture, vertex_colors) -> torch.Tensor:
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1) @ mvp.T
    find, bary = rasterize(clip, faces, resolution, resolution)
    normal = interpolate(_vertex_normals(verts, faces), find, bary, faces)
    nrm = normal.norm(dim=-1, keepdim=True)
    normal = normal / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    lambert = 0.3 + 0.7 * (normal * light).sum(-1, keepdim=True).clamp(0, 1)
    if mode == "texture":
        color = _sample_texture(texture, interpolate(uv, find, bary, faces)) * lambert
    elif mode == "vertex_colors":
        color = interpolate(vertex_colors, find, bary, faces) * lambert
    else:
        color = lambert.expand(*lambert.shape[:2], 3)
    mask = (find > 0).to(color.dtype)[..., None]
    return color * mask + (1.0 - mask)    # white background


@torch.no_grad()
def render_animated_mesh(frames, faces, *, uv=None, texture=None,
                         vertex_colors=None, resolution: int = 512,
                         elev: float = 0.0, azim: float = 0.0,
                         camera_distance: float = 2.2,
                         fovy: float | None = 40.0, device=None) -> np.ndarray:
    """Render ``(T, V, 3)`` animated vertices to ``(T, R, R, 3)`` float32
    frames in [0, 1] on ``device`` (default CUDA).

    ``fovy=None`` selects the orthographic orbit camera instead of the
    perspective one. The frames are normalised to a unit box around the
    origin before the camera is applied."""
    dev = resolve_device(device)
    frames = np.asarray(frames, np.float32)
    center = (frames.min(axis=(0, 1)) + frames.max(axis=(0, 1))) / 2
    scale = float(np.abs(frames - center).max()) or 1.0
    frames = (frames - center) / scale

    proj = (perspective(fovy, 1.0, 0.1, 100.0) if fovy is not None
            else orthographic(-1.1, 1.1, -1.1, 1.1, 0.1, 100.0))
    mv = view_matrix(elev, azim, camera_distance)
    mvp = (proj @ mv).astype(np.float32)
    # headlight: light from the camera
    light = -np.linalg.inv(mv[:3, :3]) @ np.array([0, 0, -1.0], np.float32)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    if texture is not None and uv is not None:
        mode = "texture"
    elif vertex_colors is not None:
        mode = "vertex_colors"
    else:
        mode = "shaded"
    uv_t = t(uv) if mode == "texture" else None
    tex_t = t(texture) if mode == "texture" else None
    vc_t = t(vertex_colors) if mode == "vertex_colors" else None
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    mvp_t, light_t = t(mvp), t(light.astype(np.float32))
    out = torch.stack([
        _render_frame(t(v), faces_t, mvp_t, light_t, resolution, mode, uv_t,
                      tex_t, vc_t) for v in frames])
    return out.clamp(0.0, 1.0).cpu().numpy()


def render_animated_glb(path: str, **kw) -> np.ndarray:
    """Load an animated GLB (morph-target animation) with the port's reader
    and render its frames; UVs, texture or vertex colours come from the
    base mesh when present."""
    from motion324_tpu_torch.io.glb import load_animated_glb, load_glb

    base = load_glb(path)
    _, faces, frames, _ = load_animated_glb(path)
    return render_animated_mesh(
        frames, faces, uv=base.get("uv"), texture=base.get("texture"),
        vertex_colors=base.get("vertex_colors"), **kw)
