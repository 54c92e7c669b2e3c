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
    args = parser.parse_args(argv)

    import torch

    from motion324_tpu_torch.config import ModelConfig, load_model_config
    from motion324_tpu_torch.inference.pipeline import MotionPipeline

    if args.config:
        cfg = load_model_config(args.config)
    else:
        cfg = ModelConfig(dtype=torch.bfloat16)
    # forward only: decode every frame of a window in one decoder call
    cfg = dataclasses.replace(cfg, decode_frames_chunk=cfg.frames)
    if args.checkpoint is None:
        print("no checkpoint given: random weights", file=sys.stderr)
    t0 = time.perf_counter()
    pipe = MotionPipeline(cfg, state_dict=args.checkpoint, window=cfg.frames,
                          device=args.device, seed=args.seed,
                          seg_params=args.u2net)
    out = pipe.run(args.mesh, args.video, args.output,
                   smooth=not args.no_smooth, max_frames=args.max_frames,
                   use_segmentation=not args.no_segmentation,
                   uint8_upload=not args.exact)
    print(f"animated GLB written to {out} "
          f"({time.perf_counter() - t0:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
