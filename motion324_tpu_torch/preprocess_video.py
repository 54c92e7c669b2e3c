"""Preprocessing CLI: video -> segmented, centred 512^2 crops on black.

    python -m motion324_tpu_torch.preprocess_video --input clip.mp4 \
        --output clip_processed [--split-only] [--size 512] [--max-frames N] \
        [--model heuristic|u2net|isnet --weights net.pth] [--device cuda]

The port's counterpart of ``scripts/preprocess_video.py`` (the reference's
``utils/rmbg_for_black_bg.py``): per-frame background removal, one bounding
box over all frames, crop and pad to ``--size``^2. It writes
``masked_rgb/frame_XXXX.png`` and ``masks/frame_XXXX.png`` through the
PIL-free :func:`~motion324_tpu_torch.io.png.encode_png`; ``--split-only``
writes the raw frames to ``frames/`` without segmenting. ``--model
u2net|isnet`` segments with that network on ``--device`` from a torch
state dict given by ``--weights``; without weights it logs a warning and
the border-statistics heuristic runs, on the host, as it does by default.
A ``.npy`` array of ``(T, H, W, 3)`` frames needs no codec; a video file
needs cv2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ["main", "write_pngs"]


def write_pngs(directory: str, images: np.ndarray) -> None:
    """``(T, H, W[, C])`` values in [0, 1] as ``frame_XXXX.png``, scaled to
    uint8 by truncation (as the JAX CLI writes them through PIL)."""
    from motion324_tpu_torch.io.png import encode_png
    os.makedirs(directory, exist_ok=True)
    for t, img in enumerate(images):
        with open(os.path.join(directory, f"frame_{t:04d}.png"), "wb") as f:
            f.write(encode_png((img * 255).astype(np.uint8)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="video file or .npy frames")
    p.add_argument("--output", default=None,
                   help="output directory (default: <input stem>_processed)")
    p.add_argument("--split-only", action="store_true",
                   help="write the raw frames only, no segmentation")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--model", choices=("heuristic", "u2net", "isnet"),
                   default="heuristic",
                   help="segmentation network (the reference CLI uses "
                        "isnet-general-use, rmbg_for_black_bg.py:26); "
                        "u2net/isnet need --weights")
    p.add_argument("--weights", default=None,
                   help="torch state dict of the --model network")
    p.add_argument("--device", default="cuda",
                   help="where the network segments (the heuristic runs on "
                        "the host)")
    args = p.parse_args(argv)

    from motion324_tpu_torch.inference.pipeline import load_video
    from motion324_tpu_torch.inference.preprocess import preprocess_video_frames
    from motion324_tpu_torch.utils.logging import log

    stem = os.path.splitext(os.path.basename(args.input))[0]
    out_dir = args.output or f"{stem}_processed"
    frames = load_video(args.input, args.max_frames)
    log(f"loaded {len(frames)} frames from {args.input}")

    if args.split_only:
        write_pngs(os.path.join(out_dir, "frames"), frames)
        log(f"wrote {len(frames)} raw frames to {os.path.join(out_dir, 'frames')}")
        return 0

    params = model = None
    if args.model != "heuristic":
        if args.weights:
            from motion324_tpu_torch.inference.segmentation import ISNet, U2Net
            params = args.weights
            model = ISNet() if args.model == "isnet" else U2Net()
            log(f"{args.model} weights from {args.weights} on {args.device}")
        else:
            log(f"WARNING: --model {args.model} without --weights — "
                "falling back to the border-statistics heuristic")

    masked, masks, bbox = preprocess_video_frames(
        frames, params=params, size=args.size, model=model, device=args.device)
    rgb_dir = os.path.join(out_dir, "masked_rgb")
    write_pngs(rgb_dir, masked)
    write_pngs(os.path.join(out_dir, "masks"), masks)
    log(f"wrote {len(masked)} masked crops to {rgb_dir} (bbox={bbox})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
