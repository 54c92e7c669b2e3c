"""Multi-view mesh renderer over K8, the port's rasterizer.

The renderer the texture pipeline drives: orthographic orbit cameras,
normal / position / depth / mask images by barycentric interpolation, the
UV-space raster for baking, and image -> texture back-projection with
cosine-power view weighting, gated by a reliability mask. Everything stays
on the renderer's device; :meth:`MeshRenderer.bake` downloads the texture
once.

Each view, and the UV atlas, is rasterized at most once per renderer
(``raster_calls`` counts the rasterizations): the paint pipeline renders
the views for the diffusion model and the bake back-projects the same
views.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch.hy3dgen.camera import (orthographic, transform_points,
                                                view_matrix)
from motion324_tpu_torch.io.mesh import TriMesh, vertex_normals
from motion324_tpu_torch.ops.rasterizer import interpolate, rasterize
from motion324_tpu_torch.utils.image import canny, dilate, erode

__all__ = ["MeshRenderer"]


class MeshRenderer:
    """Renders one normalised mesh from orbit cameras (orthographic)."""

    def __init__(self, mesh: TriMesh, resolution: int = 512,
                 texture_size: int = 1024, camera_distance: float = 1.45,
                 ortho_scale: float = 1.2, device: str | torch.device = "cuda"):
        self.mesh = mesh
        self.resolution = resolution
        self.texture_size = texture_size
        self.camera_distance = camera_distance
        s = ortho_scale / 2
        self.proj = orthographic(-s, s, -s, s, 0.1, 100.0)
        self.device = torch.device(device)
        self._vn = vertex_normals(mesh.vertices, mesh.faces)
        to = lambda a, dt=torch.float32: torch.as_tensor(
            np.ascontiguousarray(a), dtype=dt, device=self.device)
        self._faces = to(mesh.faces, torch.int64)
        self._verts = to(mesh.vertices)
        self._normals = to(self._vn)
        self._view_cache: dict = {}
        self._uv_raster = None
        self._texel_geom = None
        self.raster_calls = 0

    def _clip_positions(self, elev: float, azim: float) -> np.ndarray:
        mv = view_matrix(elev, azim, self.camera_distance)
        return transform_points(self.proj @ mv, self.mesh.vertices)

    def render_view(self, elev: float, azim: float) -> dict:
        """One view, memoised per (elev, azim): tensors on the device,
        ``mask`` (H, W) bool, ``depth`` (H, W), ``normal`` (H, W, 3)
        world-space unit normals, ``position`` (H, W, 3) world xyz,
        ``findices`` and ``bary``."""
        key = (float(elev), float(azim))
        cached = self._view_cache.get(key)
        if cached is not None:
            return cached
        pos_clip = torch.as_tensor(self._clip_positions(elev, azim),
                                   device=self.device)
        res = self.resolution
        find, bary = rasterize(pos_clip, self._faces, res, res)
        self.raster_calls += 1
        faces = self._faces
        normal = interpolate(self._normals, find, bary, faces)
        norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
        normal = normal / torch.where(norm == 0, torch.ones_like(norm), norm)
        position = interpolate(self._verts, find, bary, faces)
        z = interpolate(pos_clip[:, 2:3] / pos_clip[:, 3:4], find, bary,
                        faces)[..., 0]
        view = {"mask": find > 0, "normal": normal, "position": position,
                "depth": z, "findices": find, "bary": bary}
        self._view_cache[key] = view
        return view

    def rasterize_uv(self):
        """Which face covers each texel of the UV atlas: ``(findices,
        bary)`` at texture_size^2, UV [0, 1] mapped to clip xy with the V
        axis flipped (texture row 0 is v = 1)."""
        if self._uv_raster is not None:
            return self._uv_raster
        uv = self.mesh.uv
        if uv is None:
            raise ValueError("mesh has no UV coordinates")
        pos = np.zeros((len(uv), 4), np.float32)
        pos[:, 0] = uv[:, 0] * 2 - 1
        pos[:, 1] = 1 - 2 * uv[:, 1]
        pos[:, 3] = 1.0
        self.raster_calls += 1
        s = self.texture_size
        self._uv_raster = rasterize(torch.as_tensor(pos, device=self.device),
                                    self._faces, s, s)
        return self._uv_raster

    def reliability_mask(self, view: dict, angle_thres_deg: float = 75.0
                         ) -> torch.Tensor:
        """(H, W) bool: pixels reliable for back-projection. The visible mask
        eroded by a kernel scaled to the resolution (silhouettes out), minus
        the Canny depth edges dilated by the same kernel, minus grazing
        pixels (normal against the view beyond ``angle_thres_deg``)."""
        mask = view["mask"].to(torch.uint8)
        depth = view["depth"]
        k = max(int((2 / 512) * self.resolution), 1) * 2 + 1
        shrunk = erode(mask, k) > 0
        vis = mask > 0
        if bool(vis.any()):
            dmin, dmax = depth[vis].min(), depth[vis].max()
            dn = (depth - dmin) / torch.clamp(dmax - dmin, min=1e-8) * vis
            edges = canny((dn * 255).to(torch.uint8), 30, 80)
            edges = dilate(edges, k) > 0
        else:
            edges = torch.zeros_like(vis)
        cosang = view.get("view_cos")
        if cosang is None:
            cosang = view["normal"][..., 2].abs()
        ok_angle = cosang.double() >= np.cos(np.deg2rad(angle_thres_deg))
        return shrunk & ~edges & ok_angle

    def _texel_geometry(self):
        """Per-texel surface position, normal and coverage from the UV
        raster, computed once and kept on the device."""
        if self._texel_geom is None:
            uv_find, uv_bary = self.rasterize_uv()
            pos = interpolate(self._verts, uv_find, uv_bary, self._faces)
            nrm = interpolate(self._normals, uv_find, uv_bary, self._faces)
            self._texel_geom = (pos, nrm, (uv_find > 0).float())
        return self._texel_geom

    def _back_project_dev(self, view_image, elev: float, azim: float,
                          cos_power: float, angle_thres_deg: float):
        """``(colour * weight (S, S, 3), weight (S, S, 1))`` on the device."""
        texel_pos, texel_nrm, covered = self._texel_geometry()
        view = self.render_view(elev, azim)
        mv = view_matrix(elev, azim, self.camera_distance)
        cam_dir = -(np.linalg.inv(mv[:3, :3]) @ np.array([0, 0, -1.0]))
        cam = torch.as_tensor(cam_dir.astype(np.float32), device=self.device)
        view["view_cos"] = (view["normal"] @ cam).clamp(0, 1)
        depth = view["depth"]
        vis = view["mask"]
        span = float(depth[vis].max() - depth[vis].min()) if bool(vis.any()) else 1.0
        z_tol = 2e-3 * span + 1e-4
        rel = self.reliability_mask(view, angle_thres_deg).float()
        m = torch.as_tensor((self.proj @ mv).astype(np.float32),
                            device=self.device)
        image = torch.as_tensor(view_image, dtype=torch.float32,
                                device=self.device)
        return _back_project_math(texel_pos, texel_nrm, covered, image, depth,
                                  rel, m, cam, float(max(z_tol, 1e-3)),
                                  float(cos_power), self.resolution)

    def back_project(self, view_image, elev: float, azim: float,
                     cos_power: float = 4.0, angle_thres_deg: float = 75.0):
        """Project a view image into UV space: every covered texel's surface
        point is projected into the view, the image sampled bilinearly and
        weighted by ``cos^power`` of the normal against the view, gated by
        depth visibility and the reliability mask. Returns numpy
        ``(texture (S, S, 3), weight (S, S, 1))``."""
        c, w = self._back_project_dev(view_image, elev, azim, cos_power,
                                      angle_thres_deg)
        return c.cpu().numpy(), w.cpu().numpy()

    def bake(self, view_images, views, cos_power: float = 4.0):
        """Merge views (``(azim, elev, weight)``) into one texture by their
        normalised weighted sum, accumulated on the device. Returns numpy
        ``(texture (S, S, 3), covered (S, S) bool)``."""
        s = self.texture_size
        acc = torch.zeros((s, s, 3), dtype=torch.float32, device=self.device)
        wacc = torch.zeros((s, s, 1), dtype=torch.float32, device=self.device)
        for img, (azim, elev, vw) in zip(view_images, views):
            c, w = self._back_project_dev(img, elev, azim, cos_power, 75.0)
            acc = acc + c * vw
            wacc = wacc + w * vw
        tex = acc / wacc.clamp(min=1e-8)
        return tex.cpu().numpy(), (wacc[..., 0] > 1e-8).cpu().numpy()


def _bilinear(img, px, py):
    """Clamp-to-edge bilinear samples of ``img`` (H, W, C) at (px, py)."""
    h, w = img.shape[:2]
    x0 = px.floor().long().clamp(0, w - 1)
    y0 = py.floor().long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (px - x0).clamp(0, 1)[:, None]
    fy = (py - y0).clamp(0, 1)[:, None]
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def _back_project_math(texel_pos, texel_nrm, covered, view_image, depth_img,
                       rel_img, M, cam_dir, z_tol: float, cos_power: float,
                       resolution: int):
    """Per-view back-projection: texels projected into the view, colour
    sampled bilinearly, gated by |z_texel - z_view| < z_tol, by the
    reliability mask (all four bilinear neighbours reliable) and by
    ``cos^power`` of the view angle. The depth and reliability buffers stay
    at the render resolution even for a larger view image."""
    s = texel_pos.shape[0]
    p = texel_pos.reshape(-1, 3)
    clip = p @ M[:3, :3].T + M[:3, 3]
    wcol = p @ M[3, :3] + M[3, 3]
    ndc = clip[:, :2] / wcol[:, None]
    h, w = view_image.shape[:2]
    px = (ndc[:, 0] * 0.5 + 0.5) * (w - 1)
    py = (0.5 + 0.5 * ndc[:, 1]) * (h - 1)
    pxb = (ndc[:, 0] * 0.5 + 0.5) * (resolution - 1)
    pyb = (0.5 + 0.5 * ndc[:, 1]) * (resolution - 1)
    color = _bilinear(view_image, px, py).reshape(s, s, -1)
    z_tex = (clip[:, 2] / wcol).reshape(s, s)
    z_ref = _bilinear(depth_img[..., None], pxb, pyb)[:, 0].reshape(s, s)
    visible = (z_tex - z_ref).abs() < z_tol
    rel_tex = _bilinear(rel_img[..., None], pxb, pyb)[:, 0].reshape(s, s)
    reliable = rel_tex > 0.999
    cosang = texel_nrm @ cam_dir
    weight = cosang.clamp(0, 1) ** cos_power
    weight = weight * covered * visible * reliable
    return color * weight[..., None], weight[..., None]
