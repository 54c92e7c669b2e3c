"""Batch image -> mesh generation with workload sharding, on the GPU.

    python -m motion324_tpu_torch.generate_assets --input-root data/ \
        --output ./generated_assets [--N 4 --n 0] [--mv] [--texture] \
        [--model 2.1] [--device cpu]

Scans ``<input-root>/*_processed/masked_rgb`` clips, splits them across
``--N`` shards by greedy size balancing, and for every ``--skip``'th frame
of each clip of shard ``--n`` runs shape generation, mesh cleanup (floaters,
degenerate faces, decimation to ``--max-faces``) and GLB export. Images are
PNG/JPEG (needs PIL) or ``.npy`` arrays (H, W, 3|4) in [0, 1] or uint8.
With ``--mv`` each clip's ``views/`` folder holds front/left/back/right
images. The weights are random, drawn from seed 0. ``--model 2.1`` builds
Hunyuan3D-2.1's shape model at its release widths
(:data:`~motion324_tpu_torch.hy3dgen.shape_pipeline.SHAPE21`: DINOv2-large,
the 21-block DiT with its mixture of experts, 4 096 latents; single-view
only; its released weights are not loaded yet). The recentering of the
input image needs cv2; ``--no-recenter`` takes images as they are.

``--texture`` paints each cleaned mesh from its image with
:class:`~motion324_tpu_torch.hy3dgen.paint_pipeline.PaintPipeline`: the
multiview diffusion model when ``--paint-unet`` and ``--paint-vae`` name
released HunyuanPaint weights (torch state dicts in the diffusers layout),
else the weight-free reprojection synthesizer. The GLB stores the texture
as PNG (:mod:`motion324_tpu_torch.io.png`, no PIL needed).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

__all__ = ["greedy_shards", "scan_jobs", "main"]


def greedy_shards(items_with_cost: list[tuple], n_shards: int):
    """Greedy balanced assignment: heaviest first onto the lightest shard.
    Items are opaque; the cost is the second tuple element."""
    shards: list[list] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for item, cost in sorted(items_with_cost, key=lambda x: -x[1]):
        i = loads.index(min(loads))
        shards[i].append(item)
        loads[i] += cost
    return shards


def _natural_key(name: str):
    """Digit runs compare numerically: 'frame_2.jpg' < 'frame_10.jpg'."""
    return [int(tok) if tok.isdigit() else tok
            for tok in re.split(r"(\d+)", name)]


def scan_jobs(input_root: str, skip: int):
    """``(frame paths, clip length)`` per ``*_processed/masked_rgb`` clip:
    every ``skip``'th frame of each clip is a job; the clip's frame count
    is its cost for shard balancing."""
    if skip < 1:
        raise ValueError(f"--skip must be >= 1, got {skip}")
    jobs = []
    for name in sorted(os.listdir(input_root)):
        rgb_dir = os.path.join(input_root, name, "masked_rgb")
        if os.path.isdir(rgb_dir):
            frames = sorted(os.listdir(rgb_dir), key=_natural_key)
            picked = [os.path.join(rgb_dir, f)
                      for i, f in enumerate(frames) if i % skip == 0]
            if picked:
                jobs.append((tuple(picked), len(frames)))
    return jobs


def _load_image(path: str):
    import numpy as np
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.asarray(img[..., :3], np.float32)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _mv_views(img_path: str) -> dict:
    """``views/{front,left,back,right}.*`` beside ``masked_rgb``."""
    views_dir = os.path.join(os.path.dirname(os.path.dirname(img_path)),
                             "views")
    found = {}
    if os.path.isdir(views_dir):
        for f in sorted(os.listdir(views_dir)):
            tag = os.path.splitext(f)[0].lower()
            if tag in ("front", "left", "back", "right"):
                found[tag] = _load_image(os.path.join(views_dir, f))
    return found


def _painter(args):
    """The texture pipeline for ``--texture`` on ``--device``."""
    from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
    model = None
    if args.paint_unet and args.paint_vae:
        import torch

        from motion324_tpu_torch.hy3dgen.paint_diffusion import \
            MultiviewDiffusion
        load = lambda path: torch.load(path, map_location="cpu",
                                       weights_only=True)
        model = MultiviewDiffusion.from_diffusers(
            load(args.paint_unet), load(args.paint_vae), device=args.device)
        print(f"loaded HunyuanPaint weights from {args.paint_unet}")
    return PaintPipeline(multiview_model=model, device=args.device)


def main(argv=None, pipeline=None, painter=None) -> int:
    """Run the CLI; ``pipeline`` replaces the release-width random-weight
    :class:`ShapeGenPipeline` that is otherwise built on ``--device``, and
    ``painter`` the texture pipeline of ``--texture``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-root", required=True)
    p.add_argument("--output", default="./generated_assets")
    p.add_argument("--N", type=int, default=1, help="total shards")
    p.add_argument("--n", type=int, default=0, help="this shard index")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--octree-resolution", type=int, default=384)
    p.add_argument("--max-faces", type=int, default=40000)
    p.add_argument("--texture", action="store_true",
                   help="paint each mesh from its image")
    p.add_argument("--paint-unet", default=None,
                   help="HunyuanPaint UNet2p5D state dict (.pt, diffusers "
                        "layout); with --paint-vae the multiview diffusion "
                        "synthesizer paints")
    p.add_argument("--paint-vae", default=None,
                   help="the SD AutoencoderKL state dict of the paint model")
    p.add_argument("--skip", type=int, default=256,
                   help="a mesh for every N-th frame of each clip (frame 0 "
                        "only for clips shorter than N)")
    p.add_argument("--seed", type=int, default=42,
                   help="sampling seed, applied anew to each image")
    p.add_argument("--mv", action="store_true",
                   help="multiview conditioning from each clip's views/")
    p.add_argument("--no-recenter", action="store_true",
                   help="take images as they are (no cv2 needed)")
    p.add_argument("--model", choices=["2.0", "2.1"], default="2.0",
                   help="the shape model of the random-weight pipeline")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.skip < 1:
        p.error(f"--skip must be >= 1, got {args.skip}")
    if args.model == "2.1" and args.mv:
        p.error("--model 2.1 takes single-view images (no --mv)")

    from motion324_tpu_torch.hy3dgen.postprocess import (reduce_faces,
                                                         remove_degenerate,
                                                         remove_floaters)
    from motion324_tpu_torch.hy3dgen.shape_pipeline import (SHAPE21,
                                                            ShapeGenPipeline)
    from motion324_tpu_torch.io.glb import export_glb

    jobs = scan_jobs(args.input_root, args.skip)
    if not jobs:
        print(f"no *_processed/masked_rgb jobs under {args.input_root}",
              file=sys.stderr)
        return 1
    mine = greedy_shards(jobs, args.N)[args.n]
    print(f"shard {args.n}/{args.N}: {len(mine)} of {len(jobs)} jobs")
    if pipeline is None:
        dims = SHAPE21 if args.model == "2.1" else {}
        pipeline = ShapeGenPipeline.init_random(
            conditioner_type="mv" if args.mv else "single",
            device=args.device, **dims)
    if args.texture and painter is None:
        painter = _painter(args)
    os.makedirs(args.output, exist_ok=True)
    for img_path, multi_frame in [(f, len(fp) > 1) for fp in mine for f in fp]:
        stem = img_path.split(os.sep)[-3].replace("_processed", "")
        if multi_frame:  # one mesh per selected frame
            stem += "_" + os.path.splitext(os.path.basename(img_path))[0]
        image = _load_image(img_path)
        cond_input = (_mv_views(img_path) or {"front": image}) if args.mv else image
        mesh = pipeline(cond_input, num_inference_steps=args.steps,
                        octree_resolution=args.octree_resolution,
                        recenter=not args.no_recenter, seed=args.seed)
        if not len(mesh.faces):
            print(f"{stem}: empty mesh, skipping")
            continue
        if len(mesh.faces) > 4_000_000:  # noise-level output guard
            mesh = reduce_faces(mesh, 2_000_000, method="cluster")
        mesh = reduce_faces(remove_degenerate(remove_floaters(mesh)),
                            args.max_faces)
        out = os.path.join(args.output, f"{stem}.glb")
        if args.texture:
            mesh = painter(mesh, cond_input.get("front", image)
                           if isinstance(cond_input, dict) else image)
        export_glb(out, mesh.vertices, mesh.faces, uv=mesh.uv,
                   texture=mesh.texture)
        print(f"{stem}: wrote {out} ({len(mesh.vertices)} vertices, "
              f"{len(mesh.faces)} faces{', textured' if args.texture else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
