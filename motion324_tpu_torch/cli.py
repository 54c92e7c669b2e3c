"""Inference CLI: existing mesh + video -> animated GLB, on the GPU.

    python -m motion324_tpu_torch.cli --mesh examples/synthetic/blob.glb \
        --video examples/synthetic/blob.mp4 --output ./outputs/blob \
        [--checkpoint ckpt.pt] [--config configs/dyscene.yaml]

Without ``--checkpoint`` the weights are random, drawn from ``--seed``. A
checkpoint is a reference ``.pt`` state dict. ``--u2net`` segments the
video with U2Net (a ``u2net.pth`` state dict) on the device instead of the
border-statistics fallback. ``--config`` reads the model
and its dtype from a YAML file (needs PyYAML); the default is the release
model of ``configs/dyscene.yaml`` in bf16. mp4 input needs cv2; a ``.npy``
array of frames does not.

On several cards, one process each, under torchrun:

    torchrun --nproc-per-node N -m motion324_tpu_torch.cli --parallel sp ...

``--parallel tp`` splits the model's heads over the N ranks, ``sp`` each
window's frames (the window must divide by N), ``pp`` the alternating
stack's pairs into N pipeline stages; ``mp`` is the world size,
as the JAX script's ``make_mesh(dp=1, mp=len(devices))``, and at world
size 1 the model runs whole. Rank 0 writes the GLB.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh", required=True, help="GLB/OBJ mesh path")
    parser.add_argument("--video", required=True, help="mp4 or .npy frames")
    parser.add_argument("--checkpoint", default=None, help="reference .pt")
    parser.add_argument("--output", default="./outputs")
    parser.add_argument("--config", default=None, help="YAML model config")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--no-smooth", action="store_true")
    parser.add_argument("--no-segmentation", action="store_true")
    parser.add_argument("--u2net", default=None,
                        help="u2net.pth weights: U2Net segmentation on the "
                             "device instead of the border fallback")
    parser.add_argument("--exact", action="store_true",
                        help="f32 video upload (no uint8 quantization)")
    parser.add_argument("--parallel", choices=("tp", "sp", "pp"), default=None,
                        help="under torchrun: tensor (tp), sequence (sp) or "
                             "pipeline (pp) parallel over the ranks, mp = "
                             "world size")
    args = parser.parse_args(argv)

    import torch

    from motion324_tpu_torch.config import ModelConfig, load_model_config
    from motion324_tpu_torch.inference.pipeline import MotionPipeline
    from motion324_tpu_torch.parallel.distributed import (destroy,
                                                          init_distributed,
                                                          local_device)

    if args.config:
        cfg = load_model_config(args.config)
    else:
        cfg = ModelConfig(dtype=torch.bfloat16)
    # forward only: decode every frame of a window in one decoder call
    cfg = dataclasses.replace(cfg, decode_frames_chunk=cfg.frames)
    if args.checkpoint is None:
        print("no checkpoint given: random weights", file=sys.stderr)
    device = args.device
    if args.parallel:
        device = local_device(args.device)
        init_distributed(device=device)
    try:
        t0 = time.perf_counter()
        pipe = MotionPipeline(cfg, state_dict=args.checkpoint,
                              window=cfg.frames, device=device,
                              seed=args.seed, seg_params=args.u2net,
                              parallel=args.parallel)
        out = pipe.run(args.mesh, args.video, args.output,
                       smooth=not args.no_smooth, max_frames=args.max_frames,
                       use_segmentation=not args.no_segmentation,
                       uint8_upload=not args.exact)
        if pipe.writer:
            print(f"animated GLB written to {out} "
                  f"({time.perf_counter() - t0:.2f} s)")
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
