"""Video-only CLI: a video -> a generated, painted mesh -> its animation, on
the GPU.

    python -m motion324_tpu_torch.video_only --video clip.npy|clip.mp4 \
        --output DIR [--checkpoint motion.pt] [--config configs/dyscene.yaml] \
        [--max-frames N] [--octree-resolution 384] [--max-faces 40000] \
        [--steps 50] [--texture] [--hy3d-ckpt model.fp16.ckpt] \
        [--shape-tiny] [--u2net u2net.pth] [--paint-unet unet.pt \
        --paint-vae vae.pt] [--no-recenter] [--device cuda] [--seed 0]

The port's counterpart of ``scripts/inference_with_video_only.py``, the
reference's ``4D_from_video`` product path, stage by stage:

1. preprocess: per-frame foreground masks (U2Net with ``--u2net``, else the
   border-statistics heuristic), one bounding box over all frames, 512^2
   crops on black;
2. shape: :class:`ShapeGenPipeline` on frame 0 (released weights with
   ``--hy3d-ckpt``, tiny random ones with ``--shape-tiny``, else random
   ones at release width);
3. cleanup: grid-cluster decimation above 4 M faces, then the largest
   component, no degenerate faces, QEM down to ``--max-faces``;
4. paint (``--texture``): :class:`PaintPipeline`, the multiview diffusion
   model with ``--paint-unet`` and ``--paint-vae``, else the weight-free
   synthesizer; ``generated_mesh.glb`` is written;
5. motion: :class:`MotionPipeline` over the crops in sliding windows,
   every frame of a window decoded at once, then smoothing;
6. ``output_animation.glb`` and ``output_animation.fbx`` in Blender
   coordinates.

An empty mesh stops the run before motion with exit code 1. Without
``--checkpoint`` the motion weights are random, drawn from ``--seed``.
``--config`` reads the motion model and ``training.num_shape_samples``
from a YAML file (needs PyYAML); the default is ``configs/dyscene.yaml``'s
model in bf16 with its 4 096 shape samples. The recentering of frame 0
before the shape model needs cv2; ``--no-recenter`` takes the crop as it
is. A ``.npy`` array of ``(T, H, W, 3)`` frames needs no codec.

:func:`run` holds the stages and takes built pipelines, so that a caller
can pass its own; after a run :data:`last_run` holds each stage's seconds
and the mesh's sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

__all__ = ["run", "clean_mesh", "predict_motion", "export_animation",
           "last_run", "main"]

# configs/dyscene.yaml's training.num_shape_samples
NUM_SHAPE_SAMPLES = 4096
# ShapeGenPipeline dims of --shape-tiny
TINY_SHAPE = dict(image_size=224, cond_dim=256, cond_depth=2, cond_heads=4,
                  dit_hidden=128, dit_heads=4, dit_depth=2, dit_single=2,
                  vae_width=128, vae_heads=4, vae_layers=2, num_latents=64,
                  latent_dim=8)

last_run: dict = {}


def clean_mesh(mesh, max_faces: int):
    """The generated mesh's cleanup: grid-cluster decimation to 2 M faces
    above 4 M (a noise-level occupancy field from random weights gives 1e8
    faces, on which QEM and the component scan would take hours), then the
    largest component, no degenerate faces, QEM to ``max_faces``. An empty
    mesh comes back as it is."""
    from motion324_tpu_torch.hy3dgen.postprocess import (reduce_faces,
                                                         remove_degenerate,
                                                         remove_floaters)
    from motion324_tpu_torch.utils.logging import log
    if not len(mesh.faces):
        return mesh
    if len(mesh.faces) > 4_000_000:
        log(f"raw mesh has {len(mesh.faces)} faces (noise-level shape "
            "output); cluster-decimating before cleanup")
        mesh = reduce_faces(mesh, 2_000_000, method="cluster")
    return reduce_faces(remove_degenerate(remove_floaters(mesh)), max_faces)


def predict_motion(motion, mesh, frames: np.ndarray,
                   num_shape_samples: int = NUM_SHAPE_SAMPLES):
    """``motion`` (a :class:`MotionPipeline`) over ``(T, H, W, 3)`` crops
    of ``mesh``: returns ``(trajectories (T, V, 3) after smoothing, the
    mesh normalised to the unit cube)``."""
    from motion324_tpu_torch.inference.pipeline import prepare_mesh_inputs
    from motion324_tpu_torch.inference.smoothing import smooth_trajectories
    inputs, _, norm_mesh = prepare_mesh_inputs(mesh, num_shape_samples)
    trajs = motion.predict(inputs, frames)
    trajs = smooth_trajectories(trajs, method="combined",
                                motion_threshold=0.002, sigma=1.0)
    return trajs[0], norm_mesh


def export_animation(output: str, norm_mesh, trajs: np.ndarray,
                     seconds: dict | None = None) -> tuple[str, str]:
    """``output_animation.glb`` (with the mesh's UVs and texture) and
    ``output_animation.fbx`` (with its UVs) under ``output``, in Blender
    coordinates; adds the seconds of each to ``seconds["glb"]`` and
    ``seconds["fbx"]``."""
    from motion324_tpu_torch.inference.pipeline import to_blender_coords
    from motion324_tpu_torch.io.fbx import export_animated_fbx
    from motion324_tpu_torch.io.glb import export_animated_glb
    seconds = {} if seconds is None else seconds
    verts, frames = to_blender_coords(norm_mesh.vertices), to_blender_coords(trajs)
    t0 = time.perf_counter()
    glb = os.path.join(output, "output_animation.glb")
    export_animated_glb(glb, verts, norm_mesh.faces, frames, uv=norm_mesh.uv,
                        texture=norm_mesh.texture)
    t1 = time.perf_counter()
    fbx = os.path.join(output, "output_animation.fbx")
    export_animated_fbx(fbx, verts, norm_mesh.faces, frames, uv=norm_mesh.uv)
    t2 = time.perf_counter()
    seconds["glb"] = seconds.get("glb", 0.0) + t1 - t0
    seconds["fbx"] = seconds.get("fbx", 0.0) + t2 - t1
    return glb, fbx


def run(video: str, output: str, models: dict, *, max_frames: int | None = None,
        steps: int = 50, octree_resolution: int = 384, max_faces: int = 40000,
        recenter: bool = True, seed: int = 0, seg_params=None,
        num_shape_samples: int = NUM_SHAPE_SAMPLES, device=None) -> int:
    """The video-only path on built pipelines: ``models`` holds ``"shape"``
    (a :class:`ShapeGenPipeline`), ``"motion"`` (a :class:`MotionPipeline`)
    and, to paint, ``"painter"`` (a :class:`PaintPipeline`). The shape
    pipeline and the painter are taken out of ``models`` after their
    stages, so that their device memory is freed before motion where
    nothing else holds them. ``seg_params``: U2Net weights for the
    segmentation on ``device``, else the border heuristic. Returns the exit
    code: 1 on an empty mesh, else 0."""
    import torch

    from motion324_tpu_torch.inference.pipeline import load_video
    from motion324_tpu_torch.inference.preprocess import preprocess_video_frames
    from motion324_tpu_torch.io.glb import export_glb
    from motion324_tpu_torch.utils.logging import log

    os.makedirs(output, exist_ok=True)
    seconds: dict[str, float] = {}
    last_run.clear()
    last_run["seconds"] = seconds
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        clock.append(time.perf_counter())
        seconds[stage] = seconds.get(stage, 0.0) + clock[-1] - clock[-2]

    frames, _, bbox = preprocess_video_frames(
        load_video(video, max_frames), params=seg_params, size=512,
        device=device)
    log(f"preprocessed {len(frames)} frames, bbox={bbox}")
    lap("preprocess")

    shape = models.pop("shape")
    mesh = shape(frames[0], num_inference_steps=steps,
                 octree_resolution=octree_resolution, recenter=recenter,
                 seed=seed)
    del shape
    last_run["raw_faces"] = len(mesh.faces)
    lap("shape")
    mesh = clean_mesh(mesh, max_faces)
    log(f"cleaned mesh: {len(mesh.vertices)} verts {len(mesh.faces)} faces")
    lap("cleanup")

    painter = models.pop("painter", None)
    if painter is not None and len(mesh.faces):
        mesh = painter(mesh, frames[0])
        lap("paint")
    del painter
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    last_run.update(vertices=len(mesh.vertices), faces=len(mesh.faces),
                    frames=len(frames))
    if not len(mesh.faces):
        log("WARNING: shape generation produced an empty mesh (random "
            "weights?); stopping before motion")
        return 1
    t0 = time.perf_counter()
    export_glb(os.path.join(output, "generated_mesh.glb"), mesh.vertices,
               mesh.faces, uv=mesh.uv, texture=mesh.texture)
    seconds["glb"] = time.perf_counter() - t0
    clock.append(time.perf_counter())

    trajs, norm_mesh = predict_motion(models["motion"], mesh, frames,
                                      num_shape_samples)
    lap("motion")
    glb, fbx = export_animation(output, norm_mesh, trajs, seconds)
    log(f"done: {glb} + {fbx}; seconds by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return 0


def _shape_pipeline(args):
    import torch

    from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline
    if args.hy3d_ckpt:
        print(f"loading Hunyuan3D shape weights from {args.hy3d_ckpt}")
        return ShapeGenPipeline.from_hunyuan_ckpt(args.hy3d_ckpt,
                                                  device=args.device)
    gen = torch.Generator(args.device).manual_seed(args.seed)
    dims = TINY_SHAPE if args.shape_tiny else {"image_size": 518}
    return ShapeGenPipeline.init_random(gen, device=args.device, **dims)


def _motion_pipeline(args):
    import torch

    from motion324_tpu_torch.config import ModelConfig, load_model_config
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    cfg = (load_model_config(args.config) if args.config
           else ModelConfig(dtype=torch.bfloat16))
    # forward only: decode every frame of a window in one decoder call
    cfg = dataclasses.replace(cfg, decode_frames_chunk=cfg.frames)
    if args.checkpoint is None:
        print("WARNING: motion model running with random weights",
              file=sys.stderr)
    return MotionPipeline(cfg, state_dict=args.checkpoint, window=cfg.frames,
                          device=args.device, seed=args.seed)


def main(argv=None, pipeline=None, painter=None, motion=None) -> int:
    """Run the CLI; ``pipeline`` replaces the shape pipeline, ``painter``
    the texture pipeline of ``--texture`` and ``motion`` the motion
    pipeline that are otherwise built on ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video", required=True, help="video file or .npy frames")
    p.add_argument("--output", default="./outputs/video_only")
    p.add_argument("--checkpoint", default=None,
                   help="motion model checkpoint (reference .pt)")
    p.add_argument("--config", default=None,
                   help="YAML config: the motion model and "
                        "training.num_shape_samples")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--octree-resolution", type=int, default=384)
    p.add_argument("--max-faces", type=int, default=40000)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--texture", action="store_true",
                   help="paint the generated mesh from frame 0")
    p.add_argument("--hy3d-ckpt", default=None,
                   help="Hunyuan3D-2 single-file checkpoint for the shape "
                        "pipeline; without it the weights are random")
    p.add_argument("--shape-tiny", action="store_true",
                   help="tiny random shape pipeline (a smoke run)")
    p.add_argument("--u2net", default=None,
                   help="U2Net weights (u2net.pth) for the segmentation; "
                        "else the border-statistics heuristic")
    p.add_argument("--paint-unet", default=None,
                   help="HunyuanPaint UNet2p5D state dict (.pt, diffusers "
                        "layout); with --paint-vae the multiview diffusion "
                        "model paints")
    p.add_argument("--paint-vae", default=None,
                   help="the SD AutoencoderKL state dict of the paint model")
    p.add_argument("--no-recenter", action="store_true",
                   help="take frame 0's crop as it is (no cv2 needed)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from motion324_tpu_torch import resolve_device
    from motion324_tpu_torch.generate_assets import _painter
    resolve_device(args.device)

    num_samples = NUM_SHAPE_SAMPLES
    if args.config:
        from motion324_tpu_torch.config import read_config
        num_samples = int(read_config(args.config).get("training", {}).get(
            "num_shape_samples", 16384))
    models = {"shape": pipeline if pipeline is not None else _shape_pipeline(args),
              "motion": motion if motion is not None else _motion_pipeline(args)}
    if args.texture:
        models["painter"] = painter if painter is not None else _painter(args)
    del pipeline, painter, motion
    return run(args.video, args.output, models, max_frames=args.max_frames,
               steps=args.steps, octree_resolution=args.octree_resolution,
               max_faces=args.max_faces, recenter=not args.no_recenter,
               seed=args.seed, seg_params=args.u2net,
               num_shape_samples=num_samples, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
