"""The port's span record as the benchmark reads it: the five span-based
per-layer metrics through the real harness (``perfbench/lib/bench.py``
``run_cell``) at tiny widths on the CPU, and, on the card, a span's device
seconds from its timing events, read without a synchronise inside it.

This file imports no JAX: the harness refuses to run in a process that has
loaded it, so the harness runs in a child process of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from motion324_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]

# the harness's CPU sizes (perfbench/tests/test_perfbench_faults.py)
TINY_MOTION = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
                   head_dim=12, image_size=28, dino_depth=1, dino_heads=3,
                   frames=4, decode_frames_chunk=4, num_shape_samples=256)
MOTION_TRAFFIC = dict(frames=4, mesh_faces=200, texture_size=64,
                      calibration_frames=2)
TINY_SHAPE = dict(image_size=28, cond_dim=48, cond_depth=1, cond_heads=3,
                  cond_native_grid=2, dit_hidden=48, dit_heads=3, dit_depth=1,
                  dit_single=1, latent_dim=8, num_latents=16, vae_width=48,
                  vae_heads=3, vae_layers=1, steps=3)

CHILD = """
import json, sys
from perfbench.lib import bench
cells = json.loads(sys.argv[1])
out = {name: bench.run_cell(name, 2 ** 31 + 23, 0.0, True, 0.0, device="cpu",
                            **kw) for name, kw in cells.items()}
print(json.dumps(out))
"""


def test_the_harness_reads_the_span_metrics():
    """A traced run of each cell (``--trace 1`` sets ``MOTION324_DEBUG=1``
    before the port is imported) reads the five metrics from the window's
    spans; being nested in them, they come to no more than the harness's
    phase timers and its ``denoise`` span."""
    cells = {"motion-clip256": dict(config_override=TINY_MOTION,
                                    params_override=MOTION_TRAFFIC),
             "shape-latents50": dict(config_override=TINY_SHAPE)}
    env = {**os.environ, "MOTION324_DEBUG": "1", "PYTHONPATH": str(ROOT)}
    env.pop("MOTION324_TRACE_DIR", None)
    done = subprocess.run([sys.executable, "-c", CHILD, json.dumps(cells)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    clip, shape = out["motion-clip256"], out["shape-latents50"]
    assert clip["correct"] and shape["correct"]
    m = {k: v["value"] for r in (clip, shape) for k, v in r["metrics"].items()}
    new = ("segment_s.clip", "encode_s.clip", "decode_s.clip",
           "glb_export_s.clip", "dit_step_s.shape")
    assert all(m[k] > 0 for k in new), m
    # the phase timers print whole tenths of a millisecond
    slack = 4 * 5e-5
    assert m["segment_s.clip"] + m["encode_s.clip"] + m["decode_s.clip"] \
        <= m["predict_s.clip"] + slack
    assert m["glb_export_s.clip"] <= m["host_s.clip"] + slack
    assert m["dit_step_s.shape"] * TINY_SHAPE["steps"] <= m["denoise_s.shape"]


@pytest.mark.cuda
def test_device_seconds_come_from_events_without_a_synchronise(monkeypatch):
    """On the card a span records a timing event at open and close and
    reads them only when the record is read: a kernel that runs long after
    its launch gives the span device seconds far above its host seconds,
    and nothing waits for the device inside the span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device seconds come from CUDA "
                    "timing events")
    monkeypatch.setattr(profiling, "_ENABLED", True)
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    profiling.reset()
    waits = []

    def spy(owner, name):
        real = getattr(owner, name)

        def wrapper(*args, **kwargs):
            waits.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, wrapper)
    spy(torch.cuda, "synchronize")
    for name in ("synchronize", "elapsed_time", "query", "wait"):
        spy(torch.cuda.Event, name)
    with profiling.span("outer"):
        with profiling.span("sleep"):
            torch.cuda._sleep(100_000_000)     # about 50 ms at 2 GHz
        assert waits == []
    assert waits == []
    recs = {r.name: r for r in profiling.spans()}
    assert "synchronize" in waits and "elapsed_time" in waits
    sleep, outer = recs["sleep"], recs["outer"]
    assert sleep.device_s > 0.02 and sleep.host_s < sleep.device_s / 2
    assert outer.device_s >= sleep.device_s
    assert sleep.parent == outer.id and sleep.root == outer.id
