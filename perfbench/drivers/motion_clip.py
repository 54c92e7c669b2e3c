"""The ``4D_from_existing`` product request: ``MotionPipeline.run(mesh.glb,
clip.npy, out_dir)`` with its defaults (U2Net segmentation in the graph,
``combined`` smoothing, the animated GLB written), one clip a request.

Set-up writes the seeded mesh (a textured UV sphere in a GLB with a PNG
atlas) and the seeded clip (``.npy`` at the model's size) under the run's
temporary directory, draws the weights on the device, builds the
pipeline and runs one request (every kernel is built and every shape seen
before the window). Each request writes its own GLB; after the window every
GLB is read back and held against the plain reference's frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import os
import re

import numpy as np

from perfbench.lib import flops, inputs, weights
from perfbench.lib.bench import Cell, stream_seed
from perfbench.reference import nets

TIMER = re.compile(r"^\[motion324 timer\] (.+): ([0-9.]+) ms$")


@dataclasses.dataclass
class State:
    cell: Cell
    pipe: object
    mesh_path: str
    clip_path: str
    mesh: tuple
    clip: np.ndarray
    outputs: list = dataclasses.field(default_factory=list)
    timers: list = dataclasses.field(default_factory=list)   # per request


def _weights(cell: Cell, clip: np.ndarray):
    import torch
    sd = weights.draw(lambda: nets.MotionModel(cell.config), stream_seed(cell.seed, 1),
                      cell.device)
    pick = np.linspace(0, len(clip) - 1, cell.params["calibration_frames"]).astype(int)
    frames = torch.from_numpy(clip[pick]).to(cell.device).float() / 255.0
    seg = weights.u2net(stream_seed(cell.seed, 2), cell.device, frames)
    return sd, seg


def setup(cell: Cell) -> State:
    import torch
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.inference.pipeline import MotionPipeline

    p, c = cell.params, cell.config
    clip = inputs.textured_clip(cell.seed, p["frames"], c["image_size"])
    verts, faces, uv = inputs.uv_sphere(p["mesh_faces"], cell.seed)
    tex = inputs.texture(cell.seed, p["texture_size"])
    mesh_path = os.path.join(cell.tmp, "mesh.glb")
    clip_path = os.path.join(cell.tmp, "clip.npy")
    written = inputs.write_textured_glb(mesh_path, verts, faces, uv, tex)
    np.save(clip_path, clip)
    sd, seg = _weights(cell, clip)
    mcfg = ModelConfig(
        feat_dim=c["feat_dim"], tokens=c["tokens"], pcd_layers=c["pcd_layers"],
        n_alternating_layers=c["n_alternating_layers"], head_dim=c["head_dim"],
        use_qk_norm=True, image_size=c["image_size"], patch_size=c["patch_size"],
        frames=c["frames"], decode_frames_chunk=c["decode_frames_chunk"],
        point_hidden=c["point_hidden"], dino_depth=c["dino_depth"],
        dino_heads=c["dino_heads"], dtype=getattr(torch, c["dtype"]))
    pipe = MotionPipeline(mcfg, state_dict=sd, window=c["frames"],
                          device=cell.device, seg_params=seg)
    del sd, seg
    state = State(cell, pipe, mesh_path, clip_path, (verts, faces, uv, tex), clip)
    glb_bytes = 12 * len(verts) * p["frames"]
    print(f"perfbench: inputs {written + clip.nbytes} bytes; each request "
          f"writes a GLB of about {glb_bytes} bytes of morph targets",
          flush=True)
    _run(state, os.path.join(cell.tmp, "warm"))
    state.timers.clear()
    return state


def _run(state: State, out_dir: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        path = state.pipe.run(state.mesh_path, state.clip_path, out_dir,
                              num_shape_samples=state.cell.config["num_shape_samples"])
    timers = {}
    for line in buf.getvalue().splitlines():
        m = TIMER.match(line.strip())
        if m:
            timers[m.group(1)] = timers.get(m.group(1), 0.0) + float(m.group(2)) / 1e3
    state.timers.append(timers)
    return path


def request(state: State, i: int) -> None:
    state.outputs.append(_run(state, os.path.join(state.cell.tmp, f"r{i}")))


@contextlib.contextmanager
def trace_spans(state: State):
    """The port's own phase spans (``phase_timer`` in
    ``inference/pipeline.py``) opened as profiler ranges while traced."""
    from torch.profiler import record_function

    import motion324_tpu_torch.inference.pipeline as pipeline
    real = pipeline.phase_timer
    names = ["video decode", "mesh load+sample", "model predict", "smoothing",
             "glb export"]

    @contextlib.contextmanager
    def spanned(name, sync=None):
        with record_function(name), real(name, sync):
            yield
    pipeline.phase_timer = spanned
    try:
        yield names
    finally:
        pipeline.phase_timer = real


def request_flops(state: State) -> float:
    """Model FLOPs of a clip: the U2Net over its frames and the motion
    model (``perfbench/lib/flops.py``)."""
    c = state.cell.config
    return float(sum(flops.clip_flops(c, len(state.clip), c["image_size"],
                                      len(state.mesh[0])).values()))


def k1_calls(state: State) -> list[tuple]:
    return flops.clip_k1_calls(state.cell.config, len(state.clip))


def reference(state: State):
    """The plain reference's GLB frames and base for the run's inputs, in
    the current ``nets.PRECISION``, from weights drawn again."""
    from perfbench.reference.pipelines import clip_frames
    sd, seg = _weights(state.cell, state.clip)
    return clip_frames(state.cell.config, sd, seg, state.mesh, state.clip,
                       state.cell.device)


def _gaps(frames, base, faces, want) -> dict:
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return {"faces_differ": float(faces.shape != want[2].shape
                                  or (faces != want[2]).any()),
            "base_rel_gap": rel(base, want[1]),
            "traj_rel_gap": rel(frames, want[0]),
            "traj_max_gap": float(np.abs(frames - want[0]).max()
                                  / np.abs(want[0]).max())}


def check(state: State, control: bool = False):
    """Free the pipeline, compute the reference's frames once (every
    request had the same inputs) and hold each request's GLB to them.
    Returns (the compared numbers, the control's readings of them: the
    reference in fp8 against the f32 one, with ``control``, else None)."""
    import torch

    from perfbench.reference import mesh as M
    cell = state.cell
    state.pipe = None
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    frames, base = reference(state)
    want = (frames, base, state.mesh[1])
    gaps = dict.fromkeys(("faces_differ", "base_rel_gap", "traj_rel_gap",
                          "traj_max_gap"), 0.0)
    for path in state.outputs:
        got_base, got_faces, got = M.read_morph_glb(path)
        for k, v in _gaps(got, got_base, got_faces, want).items():
            gaps[k] = max(gaps[k], v)
        os.remove(path)
    if not state.outputs:
        gaps = {k: float("inf") for k in gaps}
    lim = {"faces_differ": 0.0, **cell.spec["limits"]}
    out = [(k, v, lim[k]) for k, v in gaps.items()]
    if not control:
        return out, None
    nets.PRECISION["mode"] = "fp8"
    try:
        c_frames, c_base = reference(state)
    finally:
        nets.PRECISION["mode"] = "f32"
    ctl = _gaps(c_frames, c_base, state.mesh[1], want)
    return out, [(k, v, lim[k]) for k, v in ctl.items()]
