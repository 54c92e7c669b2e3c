"""Evaluation CLI: predicted results against ground truth, on the GPU.

    python -m motion324_tpu_torch.evaluate --mode geometry \
        --gt-paths gt1.glb gt2.glb --result-paths p1.glb p2.glb --output eval/
    python -m motion324_tpu_torch.evaluate --mode video \
        --gt-paths gt1.npy --result-paths pred1.npy --output eval/ \
        [--tower-weights DIR] [--device cuda]

The port's counterpart of ``scripts/evaluate.py``:

- ``--mode geometry``: pairs of animated GLBs -> per-frame Chamfer /
  F-score@0.02 / voxel IoU@128 after frame-0 scale-clipped ICP (numpy and
  scipy on the host);
- ``--mode video``: pairs of videos -> PSNR / SSIM / LPIPS / CLIP
  similarity / DreamSim per pair, and FVD across the pair sets when there
  is more than one pair, on the reference protocol: frames resized to
  512^2 and reflect-padded to 32, I3D at 224^2. The towers run on
  ``--device``.

A video is a ``.npy`` array of ``(T, H, W, 3)`` frames (no codec needed) or
an mp4 (needs cv2). ``--tower-weights`` names a directory of PyTorch state
dicts: ``lpips.pt`` (``{"vgg": torchvision vgg16.features, "lins": the
lpips package's heads}``), ``clip.pt`` (HF ``CLIPVisionModelWithProjection``
of ViT-bigG-14), ``dreamsim.pt`` (a list of ``{"kind", "cfg",
"state_dict"}`` tower specs) and ``i3d.pt`` (:class:`~motion324_tpu_torch.
evaluation.i3d.I3D`'s). A tower without its file runs with seeded random
weights and its metric is tagged ``untrained_tower``. Results go to one
JSON per pair and ``summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _tower_state(root: str | None, name: str):
    import torch
    path = os.path.join(root, f"{name}.pt") if root else None
    if path and os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return None


def _video_towers(args, device):
    """The perceptual towers of ``--mode video`` on ``device`` and the names
    of the metrics whose towers are random."""
    from motion324_tpu_torch.evaluation.clip_sim import CLIPVisionTower, DreamSim
    from motion324_tpu_torch.evaluation.video_metrics import LPIPSVGG
    lp = _tower_state(args.tower_weights, "lpips")
    clip = _tower_state(args.tower_weights, "clip")
    ds = _tower_state(args.tower_weights, "dreamsim")
    lpips = (LPIPSVGG(lp["vgg"], [lp["lins"][f"lin{i}.model.1.weight"]
                                  for i in range(5)])
             if lp is not None else LPIPSVGG())
    # a compact random tower keeps the no-weights path fast; converted
    # bigG weights go to the release architecture
    clip_tower = (CLIPVisionTower(state_dict=clip) if clip is not None
                  else CLIPVisionTower(DreamSim.SMALL))
    dreamsim = DreamSim.from_state_dicts(ds) if ds is not None else DreamSim()
    untrained = sorted(n for n, p in (("lpips", lp), ("clip_sim", clip),
                                      ("dreamsim", ds)) if p is None)
    return [m.to(device) for m in (lpips, clip_tower, dreamsim)], untrained


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["geometry", "video"], required=True)
    p.add_argument("--gt-paths", nargs="+", required=True)
    p.add_argument("--result-paths", nargs="+", required=True)
    p.add_argument("--output", default="./eval_results")
    p.add_argument("--num-points", type=int, default=50000)
    p.add_argument("--no-icp", action="store_true")
    p.add_argument("--tower-weights", default=None,
                   help="directory of the perceptual towers' state dicts "
                        "(lpips.pt, clip.pt, dreamsim.pt, i3d.pt); towers "
                        "without a file run with random weights")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from motion324_tpu_torch.utils.logging import log

    if len(args.gt_paths) != len(args.result_paths):
        raise SystemExit("--gt-paths and --result-paths must pair up")
    os.makedirs(args.output, exist_ok=True)
    summaries = []

    if args.mode == "geometry":
        from motion324_tpu_torch.evaluation.geometry import evaluate_sequence
        from motion324_tpu_torch.io.glb import load_animated_glb

        for gt_path, pred_path in zip(args.gt_paths, args.result_paths):
            _, gt_faces, gt_frames, _ = load_animated_glb(gt_path)
            _, pr_faces, pr_frames, _ = load_animated_glb(pred_path)
            out = evaluate_sequence(gt_frames, gt_faces, pr_frames, pr_faces,
                                    num_points=args.num_points,
                                    align=not args.no_icp)
            name = os.path.splitext(os.path.basename(pred_path))[0]
            with open(os.path.join(args.output, f"{name}.json"), "w") as f:
                json.dump(out, f, indent=2)
            log(f"{name}: chamfer={out['chamfer']:.5f} "
                f"fscore={out['fscore']:.4f} iou={out['iou']:.4f}")
            summaries.append({k: out[k] for k in ("chamfer", "fscore", "iou")})
    else:
        from motion324_tpu_torch import resolve_device
        from motion324_tpu_torch.evaluation.clip_sim import clip_similarity
        from motion324_tpu_torch.evaluation.video_metrics import (
            compute_fvd, lpips_distance, prepare_video, psnr, ssim)
        from motion324_tpu_torch.inference.pipeline import load_video

        device = resolve_device(args.device)
        (lpips, clip_tower, dreamsim), untrained = _video_towers(args, device)
        if untrained:
            log(f"WARNING: {', '.join(untrained)} computed with RANDOM tower "
                "weights: relative-only values, not comparable to trained-"
                "tower numbers (pass --tower-weights)")
        prep = lambda path: prepare_video(load_video(path))
        for gt_path, pred_path in zip(args.gt_paths, args.result_paths):
            gt, pr = prep(gt_path), prep(pred_path)
            t = min(len(gt), len(pr))
            rec = {
                "psnr": float(np.mean([psnr(gt[i], pr[i]) for i in range(t)])),
                "ssim": float(np.mean([ssim(gt[i], pr[i]) for i in range(t)])),
                "lpips": lpips_distance(gt[:t], pr[:t], lpips),
                "clip_sim": clip_similarity(gt[:t], pr[:t], tower=clip_tower),
                "dreamsim": dreamsim(gt[:t], pr[:t]),
            }
            if untrained:
                rec["untrained_tower"] = list(untrained)
            name = os.path.splitext(os.path.basename(pred_path))[0]
            with open(os.path.join(args.output, f"{name}.json"), "w") as f:
                json.dump(rec, f, indent=2)
            log(f"{name}: " + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                                       if not isinstance(v, list)))
            summaries.append(rec)

        if len(args.gt_paths) > 1:
            # FVD is a distance between distributions: over the pair sets
            from motion324_tpu_torch.evaluation.i3d import i3d_feature_fn
            i3d = _tower_state(args.tower_weights, "i3d")
            fn = i3d_feature_fn(state_dict=i3d, device=device)
            fvd = compute_fvd([prep(q) for q in args.gt_paths],
                              [prep(q) for q in args.result_paths], fn)
            if i3d is None:
                log("WARNING: FVD computed with a RANDOM I3D: relative-only")
                for s in summaries:
                    tags = s.setdefault("untrained_tower", [])
                    if "fvd" not in tags:
                        tags.append("fvd")
            log(f"FVD over {len(summaries)} pairs: {fvd:.3f}")
            for s in summaries:
                s["fvd"] = fvd

    agg = {k: float(np.mean([s[k] for s in summaries]))
           for k, v in summaries[0].items() if not isinstance(v, list)}
    summary = {"pairs": len(summaries), "mean": agg}
    if isinstance(summaries[0].get("untrained_tower"), list):
        summary["untrained_tower"] = summaries[0]["untrained_tower"]
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"summary over {len(summaries)} pairs: {agg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
