"""CLI: an image folder -> an mp4 (reference: scripts/images2video.py:16-81).

    python -m motion324_tpu_torch.images2video --input frames/ --output out.mp4 [--fps 12]

Frames are sorted naturally (``frame_2`` before ``frame_10``). PNGs are read
with the port's own codec (:func:`motion324_tpu_torch.io.png.decode_png`;
grey frames become RGB, alpha is dropped), JPEGs with imageio; the video is
written by :func:`motion324_tpu_torch.io.video.write_video` (cv2).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from motion324_tpu_torch.io.png import decode_png
from motion324_tpu_torch.io.video import write_video

__all__ = ["natural_key", "images_to_video", "main"]


def natural_key(name: str):
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", name)]


def _read_frame(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            img = decode_png(f.read())
        if img.shape[2] < 3:
            img = np.repeat(img[..., :1], 3, axis=2)
        return img[..., :3]
    import imageio.v3 as iio
    return iio.imread(path)[..., :3]


def images_to_video(input_dir: str, output_path: str, fps: int = 12) -> str:
    names = sorted((n for n in os.listdir(input_dir)
                    if n.lower().endswith((".png", ".jpg", ".jpeg"))),
                   key=natural_key)
    if not names:
        raise FileNotFoundError(f"no images in {input_dir}")
    frames = np.stack([_read_frame(os.path.join(input_dir, n)) for n in names])
    return write_video(output_path, frames, fps=fps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fps", type=int, default=12)
    args = p.parse_args(argv)
    out = images_to_video(args.input, args.output, args.fps)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
