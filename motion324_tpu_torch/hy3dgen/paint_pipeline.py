"""Texture painting: mesh + reference image -> textured mesh, on the GPU.

:class:`PaintPipeline` runs the JAX package's ``PaintPipeline`` stages:

1. delight the reference image (the numpy/scipy fallback of
   :mod:`~motion324_tpu_torch.hy3dgen.delight`);
2. UV-unwrap the mesh (:mod:`~motion324_tpu_torch.hy3dgen.uv_unwrap`, LSCM
   charts, with a vmapping back to the input vertices);
3. normalise it into the renderer's box and render normal and position
   maps for the six baking cameras (K8);
4. synthesise the six views: :class:`~motion324_tpu_torch.hy3dgen.
   paint_diffusion.MultiviewDiffusion`, or without weights the weight-free
   :func:`reprojection_texturizer`; with ``super_resolution`` upscale each
   view 4x (:class:`~motion324_tpu_torch.hy3dgen.super_resolution.
   Upscaler`, its weight-free Lanczos fallback without weights);
5. back-project and merge the views in UV space (K8 at the texture size);
6. fill seams by vertex colour diffusion (native C++), then the remaining
   holes by Navier-Stokes inpainting (native C++).

The output keeps the unwrapped mesh's original coordinates: baking happens
in UV space. ``last_run["seconds"]`` holds the seconds of each stage of the
last call, with the device synchronised at each stage's end.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.hy3dgen.camera import DEFAULT_VIEWS
from motion324_tpu_torch.hy3dgen.mesh_render import MeshRenderer
from motion324_tpu_torch.hy3dgen.uv_unwrap import unwrap_uv
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.native import inpaint_ns, vertex_inpaint
from motion324_tpu_torch.utils.image import resize_area
from motion324_tpu_torch.utils.logging import log

__all__ = ["PaintPipeline", "reprojection_texturizer"]


def reprojection_texturizer(cond_image, views, renders: list[dict]) -> list:
    """Weight-free view synthesizer: the front view is the conditioning
    image resized to the view; the others are a lambertian shading of the
    mesh normals times the image's mean colour. Views come back as (H, W, 3)
    f32 tensors on the renders' device, zero off the mesh."""
    cond = np.asarray(cond_image, np.float32)
    mean_color = cond.reshape(-1, 3).mean(axis=0)
    out = []
    for i, ((azim, elev, _), rnd) in enumerate(zip(views, renders)):
        mask = rnd["mask"]
        h, w = mask.shape
        if i == 0:
            img = resize_area(cond, (w, h)).to(mask.device)
        else:
            light = torch.tensor([0.3, 0.5, 0.8], device=mask.device)
            shade = (rnd["normal"].double() @ light.double()).clamp(0, 1)
            img = ((0.4 + 0.6 * shade[..., None])
                   * torch.as_tensor(mean_color, device=mask.device)).float()
        out.append(img * mask[..., None])
    return out


class PaintPipeline:
    """mesh + image -> textured mesh.

    The view synthesizer is ``multiview_model``, a callable ``(image,
    views, renders) -> list of (H, W, 3) views`` such as a
    :class:`~motion324_tpu_torch.hy3dgen.paint_diffusion.MultiviewDiffusion`;
    without one, the weight-free :func:`reprojection_texturizer`, with a
    log line saying so. ``delight=True`` removes shading from the reference
    image first. ``super_resolution=True`` upscales each view 4x before
    baking with ``upscaler`` (an :class:`~motion324_tpu_torch.hy3dgen.
    super_resolution.Upscaler`, the weight-free one when ``None``); off by
    default, as the reference ships it commented out.
    """

    def __init__(self, multiview_model: Callable | None = None,
                 resolution: int = 512, texture_size: int = 2048,
                 delight: bool = True, super_resolution: bool = False,
                 upscaler=None, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if multiview_model is None:
            log("PaintPipeline: no multiview diffusion weights — using the "
                "weight-free reprojection synthesizer")
            multiview_model = reprojection_texturizer
        self.multiview_model = multiview_model
        self.resolution = resolution
        self.texture_size = texture_size
        self.delight = delight
        self.super_resolution = super_resolution
        self.upscaler = upscaler
        self.last_run: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def renderer(self, unwrapped: TriMesh) -> MeshRenderer:
        """The renderer of an unwrapped mesh, normalised into the render box
        (the orbit cameras' ortho frustum is 1.2 wide); the output texture
        keeps the original coordinates, as baking happens in UV space."""
        v = unwrapped.vertices
        center = (v.max(0) + v.min(0)) / 2
        half = float(np.abs(v - center).max()) or 1.0
        render_mesh = unwrapped.with_vertices(
            ((v - center) * (0.45 / half)).astype(np.float32))
        return MeshRenderer(render_mesh, resolution=self.resolution,
                            texture_size=self.texture_size, device=self.device)

    def __call__(self, mesh: TriMesh, image: np.ndarray, views=None) -> TriMesh:
        views = views if views is not None else DEFAULT_VIEWS
        seconds: dict[str, float] = {}
        t = [time.perf_counter()]

        def lap(name):
            self._sync()
            t.append(time.perf_counter())
            seconds[name] = t[-1] - t[-2]

        if self.delight:
            from motion324_tpu_torch.hy3dgen.delight import delight_image
            image = delight_image(np.asarray(image, np.float32))
        lap("delight")
        unwrapped, vmapping = unwrap_uv(mesh, self.texture_size)
        lap("unwrap")
        renderer = self.renderer(unwrapped)
        renders = [renderer.render_view(elev, azim) for azim, elev, _ in views]
        lap("render")
        view_images = self.multiview_model(image, views, renders)
        lap("diffusion")
        if self.super_resolution:
            # back-projection samples each view by its own resolution, so
            # no other stage changes
            if self.upscaler is None:
                from motion324_tpu_torch.hy3dgen.super_resolution import Upscaler
                self.upscaler = Upscaler(params=None, device=self.device)
            view_images = [self.upscaler(v) for v in view_images]
            lap("super_resolution")
        texture, covered = renderer.bake(view_images, views)
        lap("bake")

        mask = (covered * 255).astype(np.uint8)
        texture, mask = vertex_inpaint(
            texture.astype(np.float32), mask,
            unwrapped.vertices.astype(np.float32),
            unwrapped.uv.astype(np.float32),
            unwrapped.faces.astype(np.int32), unwrapped.faces.astype(np.int32))
        lap("vertex_inpaint")
        hole = mask == 0
        if hole.any() and (~hole).any():
            tex_u8 = (np.clip(texture, 0, 1) * 255).astype(np.uint8)
            tex_u8 = inpaint_ns(tex_u8, (255 - mask).astype(np.uint8), 3)
            texture = tex_u8.astype(np.float32) / 255.0
        lap("hole_fill")

        coverage = float((~hole).mean())
        log(f"texture baked: {self.texture_size}^2, {coverage * 100:.0f}% "
            f"covered")
        self.last_run = {"seconds": seconds, "coverage": coverage,
                         "raster_calls": renderer.raster_calls,
                         "baked": float(covered.mean())}
        out = TriMesh(vertices=unwrapped.vertices, faces=unwrapped.faces,
                      uv=unwrapped.uv, texture=np.clip(texture, 0, 1))
        out.vmapping = vmapping  # type: ignore[attr-defined]
        return out
