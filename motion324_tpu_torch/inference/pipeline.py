"""End-to-end inference: mesh + video -> animated GLB, on one device or
split over the ranks of a process group (tensor or sequence parallel).

The ``4D_from_existing`` product path:

1. load the mesh, normalise it to the unit cube, sample textured surface
   points, transfer colours to the vertices;
2. load the video; mask its background on the device, at model resolution:
   with U2Net when the pipeline or the call holds its weights (in bf16,
   the mask ``sigmoid > 0.5``), else with the border-statistics fallback;
3. run :class:`MotionLatentModel` over sliding windows: the shape is encoded
   once and reused by every window, then each window is video-encoded and
   decoded in chunks of vertices;
4. smooth the trajectories and remap (x, y, z) -> (x, -z, y) for Blender
   where they are, on the card (``ops/smooth_traj.py``: one kernel launch
   for the clips of a forward); copy them to the host once, into a pinned
   buffer the pipeline keeps; write the animated GLB (morph targets).

:meth:`MotionPipeline.predict_batch` runs B clips of one shape through each
window in one forward, and :meth:`MotionPipeline.run_batch` groups a list
of jobs by shape for it (the ``long_videos.txt`` batch runner,
:mod:`motion324_tpu_torch.batch_inference`). Trajectories are read back as
exact f32: ``predict`` and ``predict_batch`` return them raw on the host;
``run`` and ``run_batch`` keep them on the device until they are finished.

``MotionPipeline(..., parallel="tp" | "sp", mesh=...)`` runs one process
per card (counterpart of the JAX pipeline's ``mesh=`` / ``parallel=``);
every rank loads the same mesh and video and returns the whole
trajectories, and rank 0 alone writes the GLB:

- ``"tp"``: tensor parallel over ``mesh.mp``; each rank holds its shard of
  every attention's heads and MLP units (the shard of the whole state).
- ``"sp"``: sequence parallel over the frame axis: each rank encodes,
  segments and decodes its block of each window's frames, the global
  attention gathers K/V over ``mesh.mp``, and the trajectories are
  gathered in rank order. The window must divide by the group's size; a
  clip shorter than the window whose frame count does not divide runs
  whole on every rank.
- ``"pp"``: pipeline parallel over ``mesh.mp``: each rank holds a stage of
  the alternating stack's pairs (:mod:`motion324_tpu_torch.parallel.pp`)
  and runs its encoders and the decoder replicated; each window's
  activations pass from stage to stage once (one microbatch), and every
  rank gets the last stage's tokens.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from motion324_tpu_torch import resolve_device
from motion324_tpu_torch.config import ModelConfig
from motion324_tpu_torch.inference.segmentation import (
    U2Net, load_segmentation_state_dict)
from motion324_tpu_torch.inference.windowing import sliding_window_predict
from motion324_tpu_torch.io.glb import export_animated_glb
from motion324_tpu_torch.io.mesh import (TriMesh, load_mesh, nearest_colors,
                                         normalize_unit_cube,
                                         sample_with_albedo, vertex_normals)
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.ops.smooth_traj import smooth_traj
from motion324_tpu_torch.parallel.collectives import all_gather_seq
from motion324_tpu_torch.parallel.distributed import is_initialized
from motion324_tpu_torch.parallel.mesh import Mesh, make_mesh
from motion324_tpu_torch.utils.convert import load_reference_state_dict
from motion324_tpu_torch.utils.logging import log
from motion324_tpu_torch.utils.profiling import phase_timer, span

__all__ = ["MotionPipeline", "prepare_mesh_inputs", "load_video",
           "resize_frames", "to_blender_coords", "build_u2net"]

DECODE_CHUNK = 4096  # vertices decoded per call
# the shipped smoothing (scripts/inference_with_video_mesh.py:395-405)
SMOOTHING = dict(method="combined", motion_threshold=0.002, sigma=1.0)


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
        with span("video.load"):
            return read_video(path, max_frames, dtype=dtype,
                              resize_to=resize_to)
    if not path.endswith(".npy"):
        raise ValueError(f"unsupported video file {path!r}: use .mp4, .mov, "
                         f".avi, .mkv or a .npy array of frames")
    with span("video.load"):
        frames = np.load(path)
    if frames.ndim != 4:
        raise ValueError(f"{path} holds shape {frames.shape}, not (T, H, W, C)")
    with span("video.convert"):
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


def build_u2net(params, device, dtype: torch.dtype = torch.bfloat16) -> U2Net:
    """A U2Net holding ``params`` (a ``u2net.pth`` state dict or its path)
    on ``device``, its weights in ``dtype``, in inference mode."""
    net = U2Net()
    net.load_state_dict(load_segmentation_state_dict(params))
    return net.to(device=device, dtype=dtype).eval()


def to_blender_coords(trajs: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, -z, y)."""
    out = trajs.copy()
    out[..., 1] = -trajs[..., 2]
    out[..., 2] = trajs[..., 1]
    return out


PARALLEL_MODES = (None, "tp", "sp", "pp")


class MotionPipeline:
    """The model on one device (or split over ranks), for repeated clip
    inference.

    ``state_dict``: a reference ``.pt`` path or state dict (reference names,
    see :mod:`motion324_tpu_torch.utils.convert`); without one the weights
    are random, drawn from ``seed``. ``device`` defaults to CUDA and raises
    when no card is present; pass ``"cpu"`` for the plain PyTorch path.
    The model computes in ``cfg.dtype``.

    ``seg_params``: U2Net weights (a ``u2net.pth`` state dict or its path)
    for the in-graph segmentation, held on the device in bf16 (as in the
    JAX package) as ``seg_net``. A call that is given its own weights uses
    those, for that call.

    ``parallel``: None, ``"tp"``, ``"sp"`` or ``"pp"`` over ``mesh.mp``
    (default: ``make_mesh(dp=1, mp=world size)`` of the process group; at
    world size 1 the model runs whole).
    """

    def __init__(self, cfg: ModelConfig, state_dict=None, window: int = 12,
                 decode_chunk: int = DECODE_CHUNK, device=None, seed: int = 0,
                 seg_params=None, parallel: str | None = None,
                 mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.window = window
        self.decode_chunk = decode_chunk
        if parallel not in PARALLEL_MODES:
            raise ValueError(f"parallel must be None, 'tp', 'sp' or 'pp', not "
                             f"{parallel!r}")
        if parallel is not None and mesh is None:
            mesh = make_mesh(dp=1, mp=(torch.distributed.get_world_size()
                                       if is_initialized() else 1))
        self.parallel, self.mesh = parallel, mesh
        self._sp = mesh.mp if parallel == "sp" else None
        if self._sp is not None and window % self._sp.size:
            raise ValueError(
                f"sequence parallelism needs window ({window}) divisible by "
                f"the mp axis ({self._sp.size})")
        # rank 0 writes the outputs
        self.writer = not is_initialized() or torch.distributed.get_rank() == 0
        model = MotionLatentModel(cfg, seed=seed if state_dict is None else None,
                                  tp=mesh.mp if parallel == "tp" else None,
                                  pp=mesh.mp if parallel == "pp" else None)
        if state_dict is not None:
            load_reference_state_dict(model, state_dict)
        self.model = model.to(device=self.device, dtype=cfg.dtype).eval()
        self.seg_net = (None if seg_params is None
                        else build_u2net(seg_params, self.device))
        self._call_seg = None   # (params, network) of the last call's weights
        self._host_buf = None   # pinned f32, reused by each finished field

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _segmenter(self, seg_params) -> U2Net:
        """The U2Net of a call: its own weights, else the constructor's."""
        if seg_params is None:
            if self.seg_net is None:
                raise ValueError("segment='u2net' needs U2Net weights: pass "
                                 "seg_params to the pipeline or the call")
            return self.seg_net
        if self._call_seg is None or self._call_seg[0] is not seg_params:
            self._call_seg = (seg_params, build_u2net(seg_params, self.device))
        return self._call_seg[1]

    def _mask(self, x: torch.Tensor, segment, net) -> torch.Tensor:
        """``(B, T, H, W, 3)`` frames in [0, 1] with the background set to 0:
        ``segment`` is False (no mask), True or ``"border"`` (the
        border-statistics fallback) or ``"u2net"`` (``net`` in its dtype,
        the sigmoid in f32, the mask ``prob > 0.5``). U2Net takes one
        clip's frames per call, so that a clip's mask does not depend on
        the batch it runs in: the convolutions' algorithms, and so their
        bf16 rounding, follow the batch size."""
        with span("predict.segment"):
            if segment == "u2net":
                prob = torch.stack([net(clip) for clip in x])
                return x * (prob > 0.5)[..., None].to(x.dtype)
            if segment:
                return x * _border_segment(x)[..., None]
            return x

    @torch.inference_mode()
    def predict(self, inputs, video: np.ndarray, segment=False,
                seg_params=None) -> np.ndarray:
        """Full-video trajectories ``(1, T, N, 3)`` over sliding windows.

        ``video`` is ``(T, H, W, 3)`` float32 in [0, 1] or uint8;
        ``segment`` is False, True / ``"border"`` or ``"u2net"`` (with
        ``seg_params`` or the constructor's weights), applied on the device.
        """
        return self.predict_batch(inputs, video[None], segment, seg_params)

    @torch.inference_mode()
    def predict_batch(self, inputs, videos: np.ndarray, segment=False,
                      seg_params=None) -> np.ndarray:
        """B clips of one shape in one forward per window: ``(B, T, N, 3)``.

        ``inputs`` holds ``(B, ...)``-stacked mesh arrays (the same vertex
        count), ``videos`` is ``(B, T, H, W, 3)`` float32 in [0, 1] or
        uint8. The shape is encoded once for the B meshes; the sliding
        windows run over the time-major video ``(T, B, H, W, 3)``, so that
        each window is one ``(B, T_w, ...)`` forward.
        """
        field = self._predict_field(inputs, videos, segment, seg_params)
        with span("predict.to_host"):
            return field.cpu().numpy()

    @torch.inference_mode()
    def _predict_field(self, inputs, videos: np.ndarray, segment=False,
                       seg_params=None) -> torch.Tensor:
        """:meth:`predict_batch`'s trajectories where the model made them:
        a ``(B, T, N, 3)`` f32 tensor on the pipeline's device."""
        if segment not in (False, None, True, "border", "u2net"):
            raise ValueError(f"segment must be False, True, 'border' or "
                             f"'u2net', not {segment!r}")
        net = self._segmenter(seg_params) if segment == "u2net" else None
        m = self.model
        with span("predict.encode_shape"):
            mesh_feat = m.encode_shape(
                self._tensor(inputs["ref_shape_pcd"]),
                self._tensor(inputs["ref_shape_normals"]),
                self._tensor(inputs["ref_shape_rgbs"]))
        pts = [self._tensor(inputs[k]) for k in ("ref_pcd", "ref_normal", "ref_rgb")]
        n = pts[0].shape[1]

        def forward(window):
            # sequence parallel: this rank's block of the window's frames
            # (a window whose length does not divide runs whole)
            sp = self._sp
            if sp is not None and window.shape[0] % sp.size:
                sp = None
            if sp is not None:
                f = window.shape[0] // sp.size
                window = window[sp.rank * f:(sp.rank + 1) * f]
            x = self._tensor(np.swapaxes(window, 0, 1))
            x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
            x = self._mask(x, segment, net)
            with span("predict.encode_video"):
                tokens = m.encode_video(x, mesh_feat, sp=sp)
            parts = []
            for i in range(0, n, self.decode_chunk):
                with span("predict.decode_points"):
                    parts.append(m.decode_points(
                        tokens, *(p[:, i:i + self.decode_chunk] for p in pts)))
            return all_gather_seq(torch.cat(parts, dim=2), 1, sp)

        return sliding_window_predict(forward, np.swapaxes(videos, 0, 1),
                                      self.window, inputs["ref_pcd"])

    @torch.inference_mode()
    def _finish(self, field: torch.Tensor, smooth: bool) -> np.ndarray:
        """The ``(B, T, N, 3)`` field smoothed as shipped (:data:`SMOOTHING`)
        where ``smooth``, in Blender axes, where it lies (one launch of the
        smoothing kernel on the card), then on the host: a view of the
        pipeline's pinned buffer on the card, valid until the next call."""
        out = smooth_traj(field.contiguous(),
                          SMOOTHING["method"] if smooth else "none",
                          SMOOTHING["motion_threshold"], SMOOTHING["sigma"])
        with span("smoothing.to_host"):
            if out.device.type != "cuda":
                return out.numpy()
            buf = self._host_buf
            if buf is None or buf.numel() < out.numel():
                buf = self._host_buf = torch.empty(out.numel(),
                                                   dtype=out.dtype,
                                                   pin_memory=True)
            host = buf[:out.numel()].view(out.shape)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()
            return host.numpy()

    def _export(self, out_path: str, trajs: np.ndarray, norm_mesh, fps: int):
        """``trajs``: ``(T, N, 3)`` in Blender axes (:meth:`_finish`)."""
        with span("export.glb.coords"):
            verts = to_blender_coords(norm_mesh.vertices)
        export_animated_glb(out_path, verts, norm_mesh.faces, trajs, fps=fps,
                            uv=norm_mesh.uv, texture=norm_mesh.texture,
                            vertex_colors=norm_mesh.vertex_colors)

    def _seg_mode(self, use_segmentation: bool, seg_params):
        if not use_segmentation:
            return False
        return "u2net" if seg_params is not None or self.seg_net is not None \
            else "border"

    def run(self, mesh_path: str, video_path: str, output_dir: str,
            num_shape_samples: int = 16384, smooth: bool = True,
            fps: int = 12, max_frames: int | None = None,
            use_segmentation: bool = True, uint8_upload: bool = True,
            host_resize: bool = True, segmentation_params=None) -> str:
        """Mesh + video -> ``output_dir/output_animation.glb``.

        ``use_segmentation`` masks the background on the device: with U2Net
        when ``segmentation_params`` (a state dict or a path) or the
        constructor's weights are given, else with :func:`_border_segment`.
        ``uint8_upload`` quantizes the video to uint8 before it goes to the
        device (at most 1/510 per pixel); ``host_resize`` resizes frames to
        the model's input size on the host instead of in the model.
        ``smooth`` applies the shipped smoothing (:data:`SMOOTHING`) on the
        device; the "smoothing" phase holds it (or, without it, the Blender
        remap alone) and the one copy of the trajectories to the host.
        """
        os.makedirs(output_dir, exist_ok=True)
        with span("motion.run", trace=True):
            with phase_timer("video decode"):
                video = load_video(
                    video_path, max_frames,
                    dtype=np.uint8 if uint8_upload else np.float32,
                    resize_to=self.cfg.image_size if host_resize else None)
            with phase_timer("mesh load+sample"):
                mesh = load_mesh(mesh_path)
                inputs, _, norm_mesh = prepare_mesh_inputs(mesh,
                                                           num_shape_samples)
            # the field stays on the device: the phase ends where the
            # device's work ends
            field = []
            with phase_timer("model predict", sync=field):
                field.append(self._predict_field(
                    inputs, video[None], self._seg_mode(
                        use_segmentation, segmentation_params),
                    segmentation_params))
            with phase_timer("smoothing"):
                trajs = self._finish(field.pop(), smooth)
            out_path = os.path.join(output_dir, "output_animation.glb")
            if self.writer:
                with phase_timer("glb export"):
                    self._export(out_path, trajs[0], norm_mesh, fps)
        return out_path

    def run_batch(self, jobs, output_dir: str, num_shape_samples: int = 16384,
                  smooth: bool = True, fps: int = 12,
                  max_frames: int | None = None, use_segmentation: bool = True,
                  uint8_upload: bool = True,
                  segmentation_params=None) -> list[str]:
        """The ``long_videos.txt`` batch runner: ``jobs`` is a list of
        ``(mesh_path, video_path)``; outputs go to
        ``output_dir/<video_stem>/output_animation.glb``, returned in job
        order. Jobs are loaded on a thread pool (mesh sampling, video
        decoding, host resize), grouped by video shape and mesh input shapes
        (a mesh's vertex count is part of its shape), and each group is
        predicted at batch B by :meth:`predict_batch`. Segmentation as in
        :meth:`run`.
        """
        os.makedirs(output_dir, exist_ok=True)

        def load(job):
            mesh_path, video_path = job
            inputs, _, norm_mesh = prepare_mesh_inputs(load_mesh(mesh_path),
                                                       num_shape_samples)
            video = load_video(video_path, max_frames,
                               dtype=np.uint8 if uint8_upload else np.float32,
                               resize_to=self.cfg.image_size)
            stem = os.path.splitext(os.path.basename(video_path))[0]
            return inputs, norm_mesh, video, stem

        with ThreadPoolExecutor(min(8, max(1, len(jobs)))) as pool:
            loaded = list(pool.map(load, jobs))
        groups: dict = {}
        for idx, (inputs, _, video, _) in enumerate(loaded):
            key = (video.shape,) + tuple(sorted(
                (k, v.shape[1:]) for k, v in inputs.items()))
            groups.setdefault(key, []).append(idx)

        segment = self._seg_mode(use_segmentation, segmentation_params)
        out_paths = [None] * len(loaded)
        for key, idxs in groups.items():
            batch_inputs = {k: np.concatenate([loaded[i][0][k] for i in idxs])
                            for k in loaded[idxs[0]][0]}
            videos = np.stack([loaded[i][2] for i in idxs])
            t0 = time.perf_counter()
            trajs = self._finish(self._predict_field(
                batch_inputs, videos, segment, segmentation_params), smooth)
            dt = time.perf_counter() - t0
            log(f"batch predict: {len(idxs)} clips x {key[0][0]} frames in "
                f"{dt:.2f} s ({len(idxs) / dt:.2f} clips/s)")
            for bi, i in enumerate(idxs):
                _, norm_mesh, _, stem = loaded[i]
                clip_dir = os.path.join(output_dir, stem)
                os.makedirs(clip_dir, exist_ok=True)
                out_paths[i] = os.path.join(clip_dir, "output_animation.glb")
                if self.writer:
                    self._export(out_paths[i], trajs[bi], norm_mesh, fps)
        return out_paths
