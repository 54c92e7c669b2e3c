"""Batch inference over a list of (mesh, video) jobs, on the GPU.

    python -m motion324_tpu_torch.batch_inference --list long_videos.txt \\
        --output ./outputs/batch [--checkpoint ckpt.pt] [--u2net u2net.pth] \\
        [--batch 4] [--config configs/dyscene.yaml] [training.frames=256]

The ``long_videos.txt`` batch runner, beside ``scripts/batch_inference.py``: one
job per line, ``mesh_path video_path`` (blank lines and ``#`` comments are
skipped; a line with fewer than two fields counts as a failed job). Each
clip's GLB goes to ``<output>/<video stem>/output_animation.glb``. With
``--batch B`` the jobs run B at a time through ``MotionPipeline.run_batch``
(same-shape clips in one forward); a group that fails is retried job by
job, so one bad job fails only itself. The exit code is 1 when any job
failed.

Without ``--checkpoint`` the weights are random, drawn from ``--seed``.
``--config`` and ``key=value`` overrides need PyYAML; without them the model
is the release model of ``configs/dyscene.yaml`` in bf16. ``--u2net``
segments with U2Net on the device instead of the border fallback. A video
is an mp4 (needs cv2) or a ``.npy`` array of frames.

``--parallel tp|sp|pp`` under ``torchrun --nproc-per-node N`` splits the
model (tp: heads; pp: the alternating stack's pairs, in stages) or each
window's frames (sp) over the N ranks, one card each; ``mp`` is the world
size, and rank 0 writes the GLBs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                              "dyscene.yaml")


def decode_frames_chunk(window: int, batch: int) -> int:
    """Frames folded into one decoder call: about 32 rows of chunk x B, the
    largest divisor of the window not above that (the rule of
    scripts/batch_inference.py)."""
    chunk = max(1, min(window, 32 // max(batch, 1)))
    while window % chunk:
        chunk -= 1
    return chunk


def read_jobs(path: str) -> tuple[list[tuple[str, str]], list[str]]:
    """``(jobs, malformed lines)`` of a job list."""
    jobs, bad = [], []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.split()
            if len(fields) < 2:
                bad.append(line.rstrip("\n"))
            else:
                jobs.append((fields[0], fields[1]))
    return jobs, bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Not in the port: --yuv-upload (I420 frames) was built for "
               "the TPU's host link and stays with the JAX package's "
               "scripts/batch_inference.py.")
    parser.add_argument("--list", required=True, dest="list_path",
                        help="job list: 'mesh_path video_path' per line")
    parser.add_argument("--checkpoint", default=None, help="reference .pt")
    parser.add_argument("--output", default="./outputs/batch")
    parser.add_argument("--config", default=None, help="YAML config")
    parser.add_argument("--u2net", default=None,
                        help="u2net.pth weights: U2Net segmentation on the "
                             "device instead of the border fallback")
    parser.add_argument("--batch", type=int, default=1,
                        help="clips per forward: jobs of one shape run B at "
                             "a time (B=1 runs them one by one)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parallel", choices=("tp", "sp", "pp"), default=None,
                        help="under torchrun: tensor (tp), sequence (sp) or "
                             "pipeline (pp) parallel over the ranks, mp = "
                             "world size")
    parser.add_argument("overrides", nargs="*", help="key.path=value")
    args = parser.parse_args(argv)

    import torch

    from motion324_tpu_torch.config import (ModelConfig, load_model_config,
                                            read_config)
    from motion324_tpu_torch.parallel.distributed import (destroy,
                                                          init_distributed,
                                                          local_device)
    from motion324_tpu_torch.utils.logging import log

    n_samples = 16384
    if args.config or args.overrides:
        path = args.config or DEFAULT_CONFIG
        cfg = load_model_config(path, args.overrides)
        n_samples = int(read_config(path, args.overrides).get(
            "training", {}).get("num_shape_samples", n_samples))
    else:
        cfg = ModelConfig(dtype=torch.bfloat16)
    window = cfg.frames
    cfg = dataclasses.replace(
        cfg, decode_frames_chunk=decode_frames_chunk(window, args.batch))
    if args.checkpoint is None:
        log("no checkpoint given: random weights")
    device = args.device
    if args.parallel:
        device = local_device(args.device)
        init_distributed(device=device)
    try:
        return _run_jobs(args, cfg, window, device, n_samples)
    finally:
        destroy()


def _run_jobs(args, cfg, window, device, n_samples) -> int:
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    from motion324_tpu_torch.utils.logging import log

    pipeline = MotionPipeline(cfg, state_dict=args.checkpoint, window=window,
                              device=device, seed=args.seed,
                              seg_params=args.u2net, parallel=args.parallel)

    jobs, malformed = read_jobs(args.list_path)
    log(f"{len(jobs) + len(malformed)} jobs from {args.list_path}")
    for line in malformed:
        log(f"malformed line, counted as failed: {line!r}")
    failures = len(malformed)

    def run_one(mesh_path, video_path) -> int:
        stem = os.path.splitext(os.path.basename(video_path))[0]
        try:
            pipeline.run(mesh_path, video_path, os.path.join(args.output, stem),
                         num_shape_samples=n_samples)
            return 0
        except Exception as e:   # one bad job fails only itself
            log(f"job {stem} FAILED: {e!r}")
            return 1

    if args.batch > 1:
        for i in range(0, len(jobs), args.batch):
            group = jobs[i:i + args.batch]
            try:
                pipeline.run_batch(group, args.output,
                                   num_shape_samples=n_samples)
            except Exception as e:
                log(f"batch group {i // args.batch} failed ({e!r}); retrying "
                    f"its {len(group)} jobs one by one")
                failures += sum(run_one(*job) for job in group)
    else:
        failures += sum(run_one(*job) for job in jobs)
    total = len(jobs) + len(malformed)
    log(f"batch done: {total - failures}/{total} succeeded")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
