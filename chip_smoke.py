#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (motion324_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises on failure (exit code non-zero):

1. device: print the card's name and power limit; disable TF32.
2. build: compile the CUDA kernels in motion324_tpu_torch/csrc with nvcc.
3. kernels: hold each kernel against its plain PyTorch version at the main
   path's shapes (and ragged ones), in bf16 and f32; time the kernel, the
   plain version and torch's scaled_dot_product_attention as a yardstick;
   compute each call's bound from the H100's data-sheet peaks.
4. pipeline: MotionPipeline.run at release width in bf16 with seeded random
   weights on examples/synthetic/blob.glb and a seeded 16-frame 224^2 video;
   check the launch counts (17 flash, 40 folded, and per call site) and
   finite trajectories; time five clips and five calls of predict alone;
   profile one clip (device busy share, time by kernel); check agreement
   with the same run on the plain attention path, and that each of a set
   of injected attention faults moves the trajectories past that check's
   tolerance.

The line before the last is a JSON object with the per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# max |kernel - plain| allowed, as a share of max |plain|. With randn q/k/v
# and scale 1/8 each output is a softmax average of about Sk/e values of v,
# so the outputs are small: mean |out| about 0.02 (global, max 0.24), 0.01
# (shape encoder, max 0.06), 0.07-0.08 (K2 local and DINOv2, max about 1).
# bf16: both versions round the output once to bf16 and P to bf16 against
# another max (running against final), so they differ by an ulp or two of
# the largest outputs: 2^-8 to 2^-7.5 of max |plain| on the H100. A kernel
# that drops or mis-weights KV tiles errs by about mean |out|, 1/10 of max
# |plain| or more. f32: the same math summed in another order over up to
# 16 384 keys, at most 2^-17 of max |plain| on the H100.
REL_TOL = {"float32": 2.0 ** -14, "bfloat16": 2.0 ** -6}

REPLACES = {
    "flash_fwd": "motion324_tpu/ops/flash_attention.py:67",
    "folded_fwd": "motion324_tpu/ops/folded_attention.py:50",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from motion324_tpu_torch.ops import _build
    secs = _build.build()
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(_build.KERNELS)} kernels in {secs:.1f} s")


def time_ms(torch, fn, n: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``n`` back-to-back calls
    (CUDA events, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound(b, h, sq, sk, dtype_name, itemsize):
    flops = 4.0 * b * h * sq * sk * 64
    nbytes = float(itemsize) * b * h * 64 * (2 * sq + 2 * sk)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch, seed: int) -> list[dict]:
    import torch.nn.functional as F
    from motion324_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from motion324_tpu_torch.ops.folded_attention import (
        folded_attention, folded_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # (kernel, case, B, H, Sq, Sk, on the main path)
    cases = [
        ("flash_fwd", "global", 1, 12, 3888, 3888, True),
        ("flash_fwd", "shape_encoder", 1, 12, 64, 16384, True),
        ("flash_fwd", "ragged", 1, 12, 1000, 1296, False),
        ("flash_fwd", "k6_route", 1, 12, 972, 972, False),
        ("folded_fwd", "local", 12, 12, 324, 324, True),
        ("folded_fwd", "dino", 12, 12, 257, 257, True),
        ("folded_fwd", "ragged", 2, 12, 200, 1000, False),
    ]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for kname, case, b, h, sq, sk, main in cases:
            if kname == "flash_fwd":
                q = randn(b, h, sq, 64, dtype=dtype)
                k = randn(b, h, sk, 64, dtype=dtype)
                v = randn(b, h, sk, 64, dtype=dtype)
                run = lambda: flash_attention(q, k, v)
                plain = lambda: flash_attention_reference(q, k, v)
                dropped = lambda: flash_attention_reference(
                    q, k[:, :, :-64], v[:, :, :-64])
                lib = lambda: F.scaled_dot_product_attention(q, k, v)
            else:
                # q/k/v as strided views of one fused projection, as the
                # model hands them over
                qkv = randn(b, max(sq, sk), 3 * h * 64, dtype=dtype)
                q = qkv[:, :sq, : h * 64]
                k = qkv[:, :sk, h * 64: 2 * h * 64]
                v = qkv[:, :sk, 2 * h * 64:]
                run = lambda: folded_attention(q, k, v, heads=h)
                plain = lambda: folded_attention_reference(q, k, v, heads=h)
                dropped = lambda: folded_attention_reference(
                    q, k[:, :-64], v[:, :-64], heads=h)

                def lib(q=q, k=k, v=v):
                    split = lambda x: x.unflatten(-1, (h, 64)).transpose(1, 2)
                    return F.scaled_dot_product_attention(
                        split(q), split(k), split(v)).transpose(1, 2).flatten(2)
            out = run()
            want = plain()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            mean = want.float().abs().mean().item()
            tol = REL_TOL[dname] * top
            if not (err <= tol):
                raise AssertionError(f"{kname}/{case} {dname}: max |kernel - plain| "
                                     f"{err:.3e} > {tol:.3e}")
            # a kernel that loses its last 64-key tile must fail this check
            miss = (dropped().float() - want.float()).abs().max().item()
            if not (miss > tol):
                raise AssertionError(f"{kname}/{case} {dname}: the tolerance "
                                     f"{tol:.3e} misses a dropped KV tile "
                                     f"({miss:.3e})")
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, n=3, reps=3)
            lib_ms = time_ms(torch, lib)
            bound_ms, bound_by = bound(b, h, sq, sk, dname, q.element_size())
            log(f"  {kname:10s} {case:13s} {dname:8s} B{b} H{h} Sq{sq} Sk{sk}: "
                f"max|d| {err:.2e} (tol {tol:.2e} = 2^{np.log2(REL_TOL[dname]):.0f}"
                f" x max|plain| {top:.3f}; mean|plain| {mean:.4f}; last KV tile "
                f"dropped {miss:.2e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            rows.append(dict(kernel=kname, case=case, dtype=dname, main=main,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            del q, k, v, out, want
    torch.cuda.empty_cache()
    return rows


def synthetic_video(seed: int, frames: int = 16, size: int = 224) -> np.ndarray:
    """A bright disc moving over a dark, slightly noisy background (uint8),
    so that the border segmentation keeps the disc."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    color = r.randint(120, 255, size=3)
    out = np.empty((frames, size, size, 3), np.uint8)
    for t in range(frames):
        frame = 20 + r.randint(0, 4, size=(size, size, 3))
        ang = 2 * np.pi * t / frames
        cy, cx = size / 2 + 30 * np.sin(ang), size / 2 + 30 * np.cos(ang)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < 45 ** 2
        frame[disc] = color + r.randint(-10, 10, size=(disc.sum(), 3))
        out[t] = np.clip(frame, 0, 255)
    return out


def profile_clip(torch, run) -> None:
    """One clip under torch.profiler: the device's busy share of the wall
    time and the kernels that take the most device time (profiler on, so
    the wall time here is longer than an unprofiled clip's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = run()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log("  profile: the profiler saw no device time (not measured)")
        return
    groups: dict[str, float] = {}
    for e in kernels:
        n = e.key.lower()
        g = ("K1 flash_fwd" if "flash_fwd" in n else
             "K2 folded_fwd" if "folded_fwd" in n else
             "matmul" if any(w in n for w in ("gemm", "xmma", "cutlass",
                                              "nvjet"))
             else "memcpy/memset" if "memcpy" in n or "memset" in n
             else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    log(f"  profile: wall {wall_s * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / (wall_s * 1e3):.1f}% busy, "
        f"{len(kernels)} kernel names)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:14s} {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}% of device time")
    for e in kernels[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")


# call site: (kernel, launches per clip, the model's modules that make it)
SITES = {
    "shape_encoder": ("flash_fwd", 1, lambda m: [m.encoder_cross_attn]),
    "global": ("flash_fwd", 16, lambda m: list(m.global_transformer_blocks)),
    "local": ("folded_fwd", 16, lambda m: list(m.local_transformer_blocks)),
    "dino": ("folded_fwd", 24, lambda m: [m.image_encoder.model]),
}


def count_by_site(model, counters: dict):
    """Forward hooks that add the launches of each kernel during a call
    site's modules to that site. Returns (counts, hook handles)."""
    counts = {site: dict.fromkeys(counters, 0) for site in SITES}
    start = {}
    handles = []
    for site, (_, _, modules) in SITES.items():
        def pre(mod, args, site=site):
            start[site] = {k: c.launches for k, c in counters.items()}

        def post(mod, args, out, site=site):
            for k, c in counters.items():
                counts[site][k] += c.launches - start[site][k]
        for mod in modules(model):
            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post))
    return counts, handles


def set_layer_scale(torch, model, seed: int) -> None:
    """Draw DINOv2's LayerScale gammas from U(0.1, 1). The initial value of
    1e-5 mutes every DINOv2 attention and MLP branch, so the 24 DINOv2 K2
    launches would not reach the trajectories; a trained ViT-B/14 has
    LayerScale far above its initial value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))


def attention_faults(torch) -> dict:
    """Wrong kernels to inject in place of the dispatcher's K1 or K2, by
    name: (wrapper, a map from the real wrapper to a faulty one, whether
    the end-to-end check must catch it). Dropping 64 of K1's 3 888 or
    16 384 keys moves the trajectories by about as much as bf16 rounding
    does, so only the kernel phase is held to catch that fault."""
    off = 0.9 / 8.0    # the logit scale 1/sqrt(64), 10% low

    def dino_zeroed(real):
        return lambda q, k, v, **kw: (torch.zeros_like(q) if q.shape[1] == 257
                                      else real(q, k, v, **kw))

    def scale_off(real):
        return lambda q, k, v, **kw: real(q, k, v, **{**kw, "scale": off})

    def last_tile_dropped(real):
        return lambda q, k, v, **kw: real(q, k[:, :, :-64].contiguous(),
                                          v[:, :, :-64].contiguous(), **kw)
    return {
        "K2 output zeroed on DINOv2": ("folded_attention", dino_zeroed, True),
        "K2 logit scale 10% low": ("folded_attention", scale_off, True),
        "K1 logit scale 10% low": ("flash_attention", scale_off, True),
        "K1 drops the last 64 keys": ("flash_attention", last_tile_dropped,
                                      False),
    }


# max |kernel path - plain path| on the release-width trajectories, as a
# share of max |traj|. On the H100 the sound reading was 4.9e-3 to 8.1e-3
# over seeds 0-2 and the faults that must be caught read 1.25e-2 or more
# (PERF.md, Findings).
E2E_REL_TOL = 1e-2


def phase_pipeline(torch, seed: int, repo: str) -> dict:
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.inference.pipeline import (MotionPipeline,
                                                        load_video,
                                                        prepare_mesh_inputs)
    from motion324_tpu_torch.io.glb import load_animated_glb
    from motion324_tpu_torch.io.mesh import load_mesh
    from motion324_tpu_torch.ops import attention
    from motion324_tpu_torch.ops.flash_attention import flash_attention
    from motion324_tpu_torch.ops.folded_attention import folded_attention

    mesh = os.path.join(repo, "examples", "synthetic", "blob.glb")
    cfg = ModelConfig(dtype=torch.bfloat16, decode_frames_chunk=12)
    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "clip.npy")
        np.save(video, synthetic_video(seed))
        t0 = time.perf_counter()
        pipe = MotionPipeline(cfg, window=12, seed=seed)
        set_layer_scale(torch, pipe.model, seed)
        log(f"  model built in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pipe.run(mesh, video, os.path.join(tmp, "warm"))
        torch.cuda.synchronize()
        log(f"  first run (warm-up) {time.perf_counter() - t0:.2f} s")

        def clip(name):
            t0 = time.perf_counter()
            path = pipe.run(mesh, video, os.path.join(tmp, name))
            torch.cuda.synchronize()
            return path, time.perf_counter() - t0

        counters = {"flash_fwd": flash_attention,
                    "folded_fwd": folded_attention}
        by_site, hooks = count_by_site(pipe.model, counters)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        folded_attention.launches = 0
        out, clip_s = clip("kernel")
        launches = {k: c.launches for k, c in counters.items()}
        for h in hooks:
            h.remove()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"  launches in one clip: {launches}; by call site: {by_site}")
        if launches != {"flash_fwd": 17, "folded_fwd": 40}:
            raise AssertionError(f"main path launches {launches}, expected "
                                 f"17 flash_fwd and 40 folded_fwd")
        want = {site: {k: n if k == kname else 0 for k in counters}
                for site, (kname, n, _) in SITES.items()}
        if by_site != want:
            raise AssertionError(f"launches by call site {by_site}, "
                                 f"expected {want}")
        _, _, frames, _ = load_animated_glb(out)
        if frames.shape != (16, 162, 3) or not np.isfinite(frames).all():
            raise AssertionError(f"bad trajectories: shape {frames.shape}, "
                                 f"finite {np.isfinite(frames).all()}")
        times = [clip_s] + [clip(f"again{i}")[1] for i in range(4)]
        log(f"  clip: median {np.median(times):.4f} s end to end over "
            f"{len(times)} runs {[round(t, 4) for t in times]} (mesh+video "
            f"load, 2 windows, smoothing, GLB export), peak device memory "
            f"{peak_gb:.3f} GB")
        inputs, _, _ = prepare_mesh_inputs(load_mesh(mesh))
        frames_u8 = load_video(video, dtype=np.uint8)
        predict_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pipe.predict(inputs, frames_u8, segment=True)
            predict_times.append(time.perf_counter() - t0)
        log(f"  predict alone (2 windows on the card, trajectories back on "
            f"the host): median {np.median(predict_times):.4f} s over "
            f"{len(predict_times)} runs {[round(t, 4) for t in predict_times]}")
        profile_clip(torch, lambda: clip("profiled"))

        plain = MotionPipeline(ModelConfig(dtype=torch.bfloat16,
                                           decode_frames_chunk=12,
                                           attn_backend="plain"),
                               state_dict=pipe.model.state_dict(), window=12)
        t0 = time.perf_counter()
        out_plain = plain.run(mesh, video, os.path.join(tmp, "plain"))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        _, _, frames_plain, _ = load_animated_glb(out_plain)

        faulty = {}
        faults = attention_faults(torch)
        for name, (attr, fault, _) in faults.items():
            real = getattr(attention, attr)
            setattr(attention, attr, fault(real))
            try:
                path = pipe.run(mesh, video, os.path.join(tmp, "fault"))
            finally:
                setattr(attention, attr, real)
            faulty[name] = float(np.abs(load_animated_glb(path)[2]
                                        - frames_plain).max())
    err = float(np.abs(frames - frames_plain).max())
    scale = float(np.abs(frames_plain).max())
    # bf16 through 57 kernel calls, 24 blocks and 12 DINOv2 layers: the
    # two paths round attention's P and O at different points, so their
    # trajectories drift apart by a few bf16 ulps of the activations
    tol = E2E_REL_TOL * scale
    log(f"  plain-attention run {plain_s:.3f} s; trajectories max|kernel - "
        f"plain| {err:.3e} = {err / scale:.3e} x max|traj| {scale:.3f} "
        f"(tol {E2E_REL_TOL:.0e} x max|traj| = {tol:.3e})")
    for name, e in faulty.items():
        log(f"  injected fault, {name}: max|faulty - plain| {e:.3e} = "
            f"{e / scale:.3e} x max|traj|"
            f"{'' if faults[name][2] else ' (not held to the tolerance)'}")
    if not err <= tol:
        raise AssertionError(f"trajectories disagree with the plain path: "
                             f"{err:.3e} > {tol:.3e}")
    missed = [name for name, e in faulty.items()
              if faults[name][2] and not e > tol]
    if missed:
        raise AssertionError(f"the tolerance {tol:.3e} misses injected "
                             f"faults: {missed}")
    return {site: n[SITES[site][0]] for site, n in by_site.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    phase_device(torch)
    try:
        import motion324_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"motion324_tpu_torch not found next to "
                         f"chip_smoke.py: {e}")

    log("== build")
    phase_build()
    log("== kernels against their plain versions")
    rows = phase_kernels(torch, args.seed)
    log("== main path: MotionPipeline.run, release width, bf16")
    launches = phase_pipeline(torch, args.seed, repo)

    kernels = []
    for r in rows:
        if not (r["main"] and r["dtype"] == "bfloat16"):
            continue
        kernels.append({
            "name": f"{r['kernel']}/{r['case']}", "route": "cuda",
            "source": f"motion324_tpu_torch/csrc/{r['kernel']}.cu",
            "replaces": REPLACES[r["kernel"]],
            "launches": launches[r["case"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
