"""End-to-end inference on one device: mesh + video -> animated GLB.

The ``4D_from_existing`` product path:

1. load the mesh, normalise it to the unit cube, sample textured surface
   points, transfer colours to the vertices;
2. load the video; mask its background with the border-statistics
   segmentation on the device;
3. run :class:`MotionLatentModel` over sliding windows: the shape is encoded
   once and reused by every window, then each window is video-encoded and
   decoded in chunks of vertices;
4. smooth the trajectories, remap (x, y, z) -> (x, -z, y) for Blender and
   write the animated GLB (morph targets).

Trajectories are read back as exact f32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.smoothing import smooth_trajectories
from motion324_tpu_torch.inference.windowing import sliding_window_predict
from motion324_tpu_torch.io.glb import export_animated_glb
from motion324_tpu_torch.io.mesh import (TriMesh, load_mesh, nearest_colors,
                                         normalize_unit_cube,
                                         sample_with_albedo, vertex_normals)
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.utils.convert import load_reference_state_dict

__all__ = ["MotionPipeline", "prepare_mesh_inputs", "load_video",
           "resize_frames", "to_blender_coords"]

DECODE_CHUNK = 4096  # vertices decoded per call


def resize_frames(video: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of ``(T, H, W, 3)`` frames to ``size``^2 on the host
    (cv2 INTER_LINEAR, the half-pixel convention of the model's own resize).
    Frames already at that size come back untouched, without cv2."""
    if video.shape[1] == size and video.shape[2] == size:
        return video
    import cv2
    out = np.empty((video.shape[0], size, size, 3), dtype=video.dtype)
    for i, frame in enumerate(video):
        cv2.resize(frame, (size, size), dst=out[i],
                   interpolation=cv2.INTER_LINEAR)
    return out


def load_video(path: str, max_frames: int | None = None,
               dtype=np.float32, resize_to: int | None = None) -> np.ndarray:
    """Read ``(T, H, W, 3)`` RGB frames: float32 in [0, 1] or uint8.

    ``.mp4``/``.mov``/``.avi``/``.mkv`` decode through cv2; ``.npy`` holds a
    ``(T, H, W, 3)`` uint8 or [0, 1] float array (no codec needed).
    """
    if path.endswith((".mp4", ".mov", ".avi", ".mkv")):
        from motion324_tpu_torch.io.video import read_video
        return read_video(path, max_frames, dtype=dtype, resize_to=resize_to)
    if not path.endswith(".npy"):
        raise ValueError(f"unsupported video file {path!r}: use .mp4, .mov, "
                         f".avi, .mkv or a .npy array of frames")
    frames = np.load(path)
    if frames.ndim != 4:
        raise ValueError(f"{path} holds shape {frames.shape}, not (T, H, W, C)")
    if max_frames:
        frames = frames[:max_frames]
    frames = frames[..., :3]
    if np.issubdtype(frames.dtype, np.integer):
        unit = frames.astype(np.float32) / np.iinfo(frames.dtype).max
    else:
        unit = np.clip(frames.astype(np.float32), 0.0, 1.0)
    out = ((unit * 255 + 0.5).astype(np.uint8)
           if np.dtype(dtype) == np.uint8 else unit)
    if resize_to:
        out = resize_frames(out, resize_to)
    return out


def prepare_mesh_inputs(mesh: TriMesh, num_shape_samples: int = 16384,
                        seed: int = 0):
    """Normalise and sample a mesh into the model's inputs (host numpy).

    Returns ``(inputs, (center, scale), normalised_mesh)``; ``inputs`` holds
    batched ``(1, ...)`` float32 arrays.
    """
    verts, center, scale = normalize_unit_cube(mesh.vertices)
    mesh = mesh.with_vertices(verts)
    pts, normals, colors = sample_with_albedo(mesh, num_shape_samples, seed=seed)
    vert_rgb = nearest_colors(pts, colors, verts)
    vnorm = vertex_normals(verts, mesh.faces)
    inputs = {
        "ref_shape_pcd": pts[None], "ref_shape_normals": normals[None],
        "ref_shape_rgbs": colors[None],
        "ref_pcd": verts[None].astype(np.float32), "ref_normal": vnorm[None],
        "ref_rgb": vert_rgb[None].astype(np.float32),
    }
    return inputs, (center, scale), mesh


def _border_segment(x: torch.Tensor, border: int = 8,
                   sigma_factor: float = 4.0) -> torch.Tensor:
    """Foreground mask ``(B, T, H, W)`` of ``(B, T, H, W, 3)`` frames: a pixel
    is foreground when some channel lies more than ``sigma_factor`` standard
    deviations (population) from the mean colour of the frame's border."""
    h, w = x.shape[2], x.shape[3]
    bmask = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    bmask[:border] = True
    bmask[-border:] = True
    bmask[:, :border] = True
    bmask[:, -border:] = True
    border_pix = x[:, :, bmask]                              # (B, T, P, 3)
    mean = border_pix.mean(dim=2)[:, :, None, None]
    std = border_pix.std(dim=2, correction=0)[:, :, None, None] + 1e-3
    dist = (x - mean).abs() / std
    return (dist.amax(dim=-1) > sigma_factor).to(x.dtype)


def to_blender_coords(trajs: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, -z, y)."""
    out = trajs.copy()
    out[..., 1] = -trajs[..., 2]
    out[..., 2] = trajs[..., 1]
    return out


class MotionPipeline:
    """The model on one device, for repeated clip inference.

    ``state_dict``: a reference ``.pt`` path or state dict (reference names,
    see :mod:`motion324_tpu_torch.utils.convert`); without one the weights
    are random, drawn from ``seed``. ``device`` defaults to CUDA and raises
    when no card is present; pass ``"cpu"`` for the plain PyTorch path.
    The model computes in ``cfg.dtype``.
    """

    def __init__(self, cfg: ModelConfig, state_dict=None, window: int = 12,
                 decode_chunk: int = DECODE_CHUNK, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.window = window
        self.decode_chunk = decode_chunk
        model = MotionLatentModel(cfg, seed=seed if state_dict is None else None)
        if state_dict is not None:
            load_reference_state_dict(model, state_dict)
        self.model = model.to(device=self.device, dtype=cfg.dtype).eval()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def predict(self, inputs, video: np.ndarray,
                segment: bool = False) -> np.ndarray:
        """Full-video trajectories ``(1, T, N, 3)`` over sliding windows.

        ``video`` is ``(T, H, W, 3)`` float32 in [0, 1] or uint8;
        ``segment`` applies :func:`_border_segment` on the device.
        """
        m = self.model
        mesh_feat = m.encode_shape(self._tensor(inputs["ref_shape_pcd"]),
                                   self._tensor(inputs["ref_shape_normals"]),
                                   self._tensor(inputs["ref_shape_rgbs"]))
        pts = [self._tensor(inputs[k]) for k in ("ref_pcd", "ref_normal", "ref_rgb")]
        n = pts[0].shape[1]

        def forward(window):
            x = self._tensor(window[None])
            x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
            if segment:
                x = x * _border_segment(x)[..., None]
            tokens = m.encode_video(x, mesh_feat)
            parts = [m.decode_points(tokens, *(p[:, i:i + self.decode_chunk]
                                               for p in pts))
                     for i in range(0, n, self.decode_chunk)]
            return torch.cat(parts, dim=2).cpu().numpy()

        return sliding_window_predict(forward, video, self.window,
                                      inputs["ref_pcd"])

    def run(self, mesh_path: str, video_path: str, output_dir: str,
            num_shape_samples: int = 16384, smooth: bool = True,
            fps: int = 12, max_frames: int | None = None,
            use_segmentation: bool = True, uint8_upload: bool = True,
            host_resize: bool = True) -> str:
        """Mesh + video -> ``output_dir/output_animation.glb``.

        ``use_segmentation`` masks the background with
        :func:`_border_segment`. ``uint8_upload`` quantizes the video to uint8
        before it goes to the device (at most 1/510 per pixel);
        ``host_resize`` resizes frames to the model's input size on the host
        instead of in the model.
        """
        os.makedirs(output_dir, exist_ok=True)
        video = load_video(video_path, max_frames,
                           dtype=np.uint8 if uint8_upload else np.float32,
                           resize_to=self.cfg.image_size if host_resize else None)
        mesh = load_mesh(mesh_path)
        inputs, _, norm_mesh = prepare_mesh_inputs(mesh, num_shape_samples)
        trajs = self.predict(inputs, video, segment=use_segmentation)
        if smooth:
            trajs = smooth_trajectories(trajs, method="combined",
                                        motion_threshold=0.002, sigma=1.0)
        out_path = os.path.join(output_dir, "output_animation.glb")
        export_animated_glb(out_path, to_blender_coords(norm_mesh.vertices),
                            norm_mesh.faces, to_blender_coords(trajs[0]),
                            fps=fps, uv=norm_mesh.uv, texture=norm_mesh.texture,
                            vertex_colors=norm_mesh.vertex_colors)
        return out_path
