"""Convert an OBJ or GLB (static or morph-target animated) to FBX or Alembic.

    python -m motion324_tpu_torch.convert input.obj [-o out.fbx]
    python -m motion324_tpu_torch.convert output_animation.glb -o anim.fbx --fps 12
    python -m motion324_tpu_torch.convert output_animation.glb -o anim.abc

The port's counterpart of ``scripts/convert_fbx.py`` (the reference's
Blender converter, utils/convert_fbx.py), on the port's loaders
(:func:`~motion324_tpu_torch.io.glb.load_animated_glb`,
:func:`~motion324_tpu_torch.io.mesh.load_mesh`) and writers
(:mod:`motion324_tpu_torch.io.fbx`, :mod:`motion324_tpu_torch.io.abc`). An
animated GLB's morph targets become per-frame blend shapes (FBX) or
time-sampled positions (Alembic); ``--fps`` defaults to the GLB's keyframe
rate, else 12. Host numpy only: no device is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ["convert", "main"]


def convert(in_path: str, out_path: str, fps: float | None = None) -> str:
    """Write ``in_path`` (.obj/.glb/.gltf) as ``out_path`` (.fbx, or .abc
    for Alembic); returns ``out_path``."""
    from motion324_tpu_torch.io.glb import load_animated_glb
    from motion324_tpu_torch.io.mesh import load_mesh

    frames = uv = None
    if in_path.lower().endswith((".glb", ".gltf")):
        try:
            verts, faces, frames, times = load_animated_glb(in_path)
            if fps is None:
                dt = np.diff(np.asarray(times))
                fps = float(1.0 / np.median(dt)) if len(dt) else 12.0
            # the animated loader carries positions only: the UVs come from
            # the same primitive
            uv = load_mesh(in_path).uv
        except (KeyError, ValueError, StopIteration):
            mesh = load_mesh(in_path)      # a static GLB
            verts, faces, uv = mesh.vertices, mesh.faces, mesh.uv
    else:
        mesh = load_mesh(in_path)
        verts, faces, uv = mesh.vertices, mesh.faces, mesh.uv
    fps = 12.0 if fps is None else fps

    name = os.path.splitext(os.path.basename(in_path))[0]
    if out_path.lower().endswith(".abc"):
        from motion324_tpu_torch.io.abc import export_animated_abc
        export_animated_abc(out_path, verts, faces, trajectories=frames,
                            fps=fps, name=name)
    else:
        from motion324_tpu_torch.io.fbx import export_animated_fbx
        export_animated_fbx(out_path, verts, faces, frames=frames, fps=fps,
                            uv=uv, name=name)
    kind = "static" if frames is None else f"{len(frames)} frames"
    print(f"{in_path} -> {out_path} ({len(verts)} vertices, {kind})")
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help=".obj / .glb / .gltf input")
    ap.add_argument("-o", "--output", default=None,
                    help="output .fbx or .abc path (default: the input's "
                         "path with .fbx)")
    ap.add_argument("--fps", type=float, default=None,
                    help="animation frame rate (default: from the GLB's "
                         "keyframe times, else 12)")
    args = ap.parse_args(argv)
    out = args.output or os.path.splitext(args.input)[0] + ".fbx"
    convert(args.input, out, fps=args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
