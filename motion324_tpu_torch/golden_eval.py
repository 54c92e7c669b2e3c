"""Golden-parity harness over the five BASELINE.json configs, on the GPU.

    python -m motion324_tpu_torch.golden_eval --mode smoke --output out/ \
        [--device cpu]
    python -m motion324_tpu_torch.golden_eval --mode real \
        --assets-root examples/ --weights-root weights/ --output out/

The port's counterpart of ``scripts/golden_eval.py``: every config runs end
to end and one JSON, ``<output>/golden_eval.json``, holds each config's
status, seconds and metrics, in the same shape as the JAX harness's.

Configs:
  chili, wolf: a mesh + video through :class:`MotionPipeline` (``run``),
               the animated GLB rendered through the rasterizer
               (:mod:`~motion324_tpu_torch.evaluation.render_video`) and
               scored against the input video (:mod:`~motion324_tpu_torch.
               evaluate`'s video protocol); wolf without its mesh runs as
               tiger does;
  tiger:       a video alone through :func:`motion324_tpu_torch.video_only.
               run` (segmentation, shape, cleanup, motion), rendered and
               scored the same way;
  long:        sliding-window inference over a long clip;
  train:       one training step (loss finiteness, step seconds).

Modes:
  smoke: ``examples/synthetic/blob.*``, seeded random weights, tiny widths,
         64^2 renders scored on the evaluate CLI's fixed protocol (512^2,
         32 frames); the same code paths and JSON shape.
  real:  the assets under ``--assets-root`` and released weights under
         ``--weights-root``: ``motion.pt`` (a reference checkpoint),
         ``hy3d_dit.ckpt`` (Hunyuan3D-2), ``paint_unet.pt`` and
         ``paint_vae.pt`` (HunyuanPaint; with both, tiger is painted),
         ``u2net.pt`` and ``towers/`` (:mod:`motion324_tpu_torch.evaluate`'s
         ``--tower-weights``). A config whose weights are missing runs with
         seeded random ones and says ``weights: random``. Nothing is fetched.

``--shape-model 2.1`` makes the video-only config's shape model
Hunyuan3D-2.1's (random weights: its released ones are not loaded yet; tiny
widths in the smoke mode, the release's otherwise).

Renders are written as ``.npy`` frame stacks (no codec needed); mp4 inputs
need cv2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "examples", "synthetic")
# the tiny motion model of the smoke mode
SMOKE_MODEL = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
                   head_dim=12, frames=4, image_size=28, patch_size=14,
                   dino_depth=1, dino_heads=3)


def _maybe(path: str | None):
    return path if path and os.path.exists(path) else None


def _motion(args, smoke: bool, frames: int | None, checkpoint):
    import torch

    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    cfg = (ModelConfig(**SMOKE_MODEL) if smoke
           else ModelConfig(dtype=torch.bfloat16, frames=frames or 12))
    cfg = dataclasses.replace(cfg, decode_frames_chunk=cfg.frames)
    return MotionPipeline(cfg, state_dict=checkpoint, window=cfg.frames,
                          device=args.device, seed=args.seed)


def _score(video_path: str, glb: str, out_dir: str, args,
           resolution: int) -> dict:
    """Render ``glb`` and score it against ``video_path``: the render's
    path and the evaluate CLI's summary."""
    import numpy as np

    from motion324_tpu_torch import evaluate
    from motion324_tpu_torch.evaluation.render_video import render_animated_glb
    frames = render_animated_glb(glb, resolution=resolution, device=args.device)
    render = os.path.join(out_dir, "render.npy")
    np.save(render, (frames[:64] * 255 + 0.5).astype(np.uint8))
    argv = ["--mode", "video", "--gt-paths", video_path, "--result-paths",
            render, "--output", os.path.join(out_dir, "eval"),
            "--device", args.device]
    if args.towers:
        argv += ["--tower-weights", args.towers]
    evaluate.main(argv)
    with open(os.path.join(out_dir, "eval", "summary.json")) as f:
        return {"render": render, "metrics": json.load(f)}


def run_motion_config(name: str, mesh_path: str | None, video_path: str,
                      args, *, smoke: bool, max_frames: int | None,
                      resolution: int, frames: int | None = None) -> dict:
    """chili / wolf / long (a mesh and a video) and tiger (video only)."""
    out_dir = os.path.join(args.output, name)
    os.makedirs(out_dir, exist_ok=True)
    motion = _motion(args, smoke, frames, args.checkpoint)
    if mesh_path is not None:
        glb = motion.run(mesh_path, video_path, out_dir, max_frames=max_frames,
                         num_shape_samples=256 if smoke else 16384,
                         segmentation_params=args.u2net)
    else:
        from motion324_tpu_torch import video_only
        models = {"shape": _shape(args, smoke), "motion": motion}
        if args.paint_unet and args.paint_vae:
            from motion324_tpu_torch.generate_assets import _painter
            models["painter"] = _painter(argparse.Namespace(
                paint_unet=args.paint_unet, paint_vae=args.paint_vae,
                device=args.device))
        rc = video_only.run(video_path, out_dir, models, max_frames=max_frames,
                            steps=3 if smoke else 50,
                            octree_resolution=32 if smoke else 384,
                            max_faces=500 if smoke else 40000,
                            recenter=not smoke, seed=args.seed,
                            seg_params=args.u2net,
                            num_shape_samples=256 if smoke else 16384,
                            device=args.device)
        if rc:
            return {"status": "empty_mesh",
                    "weights": "real" if args.hy3d_ckpt else "random"}
        glb = os.path.join(out_dir, "output_animation.glb")
    res = _score(video_path, glb, out_dir, args, resolution)
    return {"status": "ok", "result_glb": glb, **res,
            "weights": "real" if args.checkpoint else "random"}


def _shape(args, smoke: bool):
    import torch

    from motion324_tpu_torch.hy3dgen.shape_pipeline import (SHAPE21,
                                                            ShapeGenPipeline)
    from motion324_tpu_torch.video_only import TINY_SHAPE
    model21 = args.shape_model == "2.1"
    if args.hy3d_ckpt and not model21:      # a released 2.0 checkpoint
        return ShapeGenPipeline.from_hunyuan_ckpt(args.hy3d_ckpt,
                                                  device=args.device)
    gen = torch.Generator(args.device).manual_seed(args.seed)
    if model21:
        # the 2.1 DiT at the tiny widths: 5 blocks, the last 2 with 4 experts
        dims = ({**TINY_SHAPE, "model": "2.1", "dit_depth": 5,
                 "dit_moe_layers": 2, "dit_experts": 4} if smoke else SHAPE21)
    else:
        dims = TINY_SHAPE if smoke else {"image_size": 518}
    return ShapeGenPipeline.init_random(gen, device=args.device, **dims)


def run_train_config(args, *, smoke: bool) -> dict:
    """One training step on a seeded batch: loss finiteness, seconds."""
    import numpy as np
    import torch

    from motion324_tpu_torch import resolve_device
    from motion324_tpu_torch.config import ModelConfig, TrainConfig
    from motion324_tpu_torch.models.motion_model import MotionLatentModel
    from motion324_tpu_torch.training.train_step import (create_train_state,
                                                         train_step)
    device = resolve_device(args.device)
    mcfg = (ModelConfig(**dict(SMOKE_MODEL, frames=2)) if smoke
            else ModelConfig(dtype=torch.bfloat16, decode_frames_chunk=12))
    tcfg = TrainConfig(grad_accum_steps=1, remat=not smoke, warmup=0,
                       seed=args.seed)
    b, t, s, n = (1, 2, 64, 64) if smoke else (2, 12, 4096, 4096)
    r = np.random.RandomState(args.seed)
    f32 = lambda *shape: torch.from_numpy(r.rand(*shape).astype(np.float32)).to(device)
    batch = {k: f32(b, s, 3) for k in ("ref_shape_pcd", "ref_shape_normals",
                                       "ref_shape_rgbs")}
    batch.update({k: f32(b, n, 3) for k in ("ref_pcd", "ref_normal", "ref_rgb")})
    batch["rgb_video"] = f32(b, t, mcfg.image_size, mcfg.image_size, 3)
    batch["point_clouds"] = f32(b, t, n, 3)
    state = create_train_state(MotionLatentModel(mcfg, seed=args.seed).to(device),
                               tcfg)
    loss0 = train_step(state, [batch], tcfg)["loss"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1 = train_step(state, [batch], tcfg)["loss"]
    dt = time.perf_counter() - t0
    ok = np.isfinite(loss0) and np.isfinite(loss1)
    return {"status": "ok" if ok else "nan_loss", "loss": loss1,
            "step_seconds": dt, "devices": 1,
            "samples_per_s": b / dt if dt else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["smoke", "real"], required=True)
    p.add_argument("--output", default="./golden_eval_out")
    p.add_argument("--weights-root", default="./weights")
    p.add_argument("--assets-root", default=None,
                   help="the real assets (chili/wolf/tiger .glb/.mp4); "
                        "needed by --mode real")
    p.add_argument("--configs", nargs="+", default=None,
                   choices=["chili", "wolf", "tiger", "long", "train"],
                   help="a subset of the configs (default: all five)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shape-model", choices=["2.0", "2.1"], default="2.0",
                   help="the random-weight shape model of the video-only "
                        "config (2.1: Hunyuan3D-2.1's, its release widths "
                        "outside the smoke mode)")
    args = p.parse_args(argv)

    from motion324_tpu_torch import resolve_device
    resolve_device(args.device)
    smoke = args.mode == "smoke"
    if not smoke and not args.assets_root:
        raise SystemExit("--mode real needs --assets-root")
    w = args.weights_root
    weight = lambda name: None if smoke else _maybe(os.path.join(w, name))
    args.checkpoint = weight("motion.pt")
    args.hy3d_ckpt = weight("hy3d_dit.ckpt")
    args.towers = weight("towers")
    args.u2net = weight("u2net.pt")
    args.paint_unet = weight("paint_unet.pt")
    args.paint_vae = weight("paint_vae.pt")

    if smoke:
        glb, mp4 = (os.path.join(SYNTH, f"blob.{e}") for e in ("glb", "mp4"))
        plan = {name: dict(mesh_path=None if name == "tiger" else glb,
                           video_path=mp4, max_frames=None if name == "long"
                           else 4, resolution=64)
                for name in ("chili", "wolf", "tiger", "long")}
    else:
        # 256-frame windows and 16 384 shape samples: the shipped
        # 4D_from_existing inference config
        a = args.assets_root
        real = lambda stem, mesh, n: dict(
            mesh_path=mesh, video_path=os.path.join(a, f"{stem}.mp4"),
            max_frames=n, resolution=512, frames=256)
        plan = {"chili": real("chili", os.path.join(a, "chili.glb"), 32),
                "wolf": real("wolf", _maybe(os.path.join(a, "wolf.glb")), 32),
                "tiger": real("tiger", None, 32),
                "long": real("chili", os.path.join(a, "chili.glb"), 128)}

    selected = args.configs or ["chili", "wolf", "tiger", "long", "train"]
    os.makedirs(args.output, exist_ok=True)
    report = {"mode": args.mode, "weights_root": None if smoke else w,
              "configs": {}}
    for name in selected:
        t0 = time.perf_counter()
        try:
            if name == "train":
                res = run_train_config(args, smoke=smoke)
            else:
                res = run_motion_config(name, args=args, smoke=smoke,
                                        **plan[name])
        except Exception:
            res = {"status": "error",
                   "traceback": traceback.format_exc(limit=12)}
        res["seconds"] = round(time.perf_counter() - t0, 2)
        report["configs"][name] = res
        print(f"[golden] {name}: {res['status']} ({res['seconds']}s)",
              flush=True)

    out_json = os.path.join(args.output, "golden_eval.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2, default=str)
    statuses = [c["status"] for c in report["configs"].values()]
    print(json.dumps({"golden_eval": out_json,
                      "ok": all(s == "ok" for s in statuses)}))
    return 0 if all(s in ("ok", "empty_mesh") for s in statuses) else 1


if __name__ == "__main__":
    sys.exit(main())
