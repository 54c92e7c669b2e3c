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
   The training path's kernels likewise: K1 and K2 with the LSE output,
   K3 and K4 (flash backward) and K5 (head-folded backward), dq/dk/dv and
   the LSE, beside torch's SDPA forward or backward.
4. pipeline: MotionPipeline.run at release width in bf16 with seeded random
   weights on examples/synthetic/blob.glb and a seeded 16-frame 224^2 video;
   check the launch counts (17 flash, 40 folded, and per call site) and
   finite trajectories; time five clips and five calls of predict alone;
   profile one clip (device busy share, time by kernel); check agreement
   with the same run on the plain attention path, and that each of a set
   of injected attention faults moves the trajectories past that check's
   tolerance.
5. training: train_step at release width, bf16 compute with f32 params and
   AdamW state, on a seeded synthetic batch at the recipe shapes (2
   micro-batches of 2 clips, 12 frames, 4 096 + 4 096 points): the exact
   launches per step and call site; one step's loss, grad norm and
   per-parameter gradients against the plain attention path, and three
   injected backward faults past those tolerances; a falling loss over 10
   steps with no skips; the median step time, samples/s, peak memory and
   one profiled step; a 16-frame window on K4; two steps of the Trainer;
   remat: forwards launched twice, the same gradients, less memory.

Launches are attributed to call sites by one spy (``launch_spy``) in both
the pipeline and the training phase. The line before the last is a JSON object with the per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    "flash_fwd_lse": "motion324_tpu/ops/flash_attention.py:67",
    "flash_bwd_fused": "motion324_tpu/ops/flash_attention.py:285",
    "flash_bwd_two_pass": "motion324_tpu/ops/flash_attention.py:221",
    "folded_fwd": "motion324_tpu/ops/folded_attention.py:50",
    "folded_fwd_lse": "motion324_tpu/ops/folded_attention.py:50",
    "folded_bwd": "motion324_tpu/ops/folded_attention.py:76",
}
SOURCES = {"flash_fwd_lse": "flash_fwd", "flash_bwd_fused": "flash_bwd",
           "flash_bwd_two_pass": "flash_bwd", "folded_fwd_lse": "folded_fwd",
           "folded_bwd": "folded_bwd"}


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


def bound(b, h, sq, sk, dtype_name, itemsize, backward=False, lse=False):
    """Least time for attention over (b, h, sq, sk, 64): the forward's
    4 b h sq sk 64 flops (2.5 times that for the backward) at the peak rate
    of the dtype, against its bytes at the memory rate, each input read once
    and each output written once: q, k, v, o (+ f32 lse) forward; q, k, v,
    o, dO, f32 lse read and dq, dk, dv written backward (rows of length Sq:
    q, o, dO, dq; of length Sk: k, v, dk, dv)."""
    flops = 4.0 * b * h * sq * sk * 64 * (2.5 if backward else 1.0)
    rows = (4 * sq + 4 * sk) if backward else (2 * sq + 2 * sk)
    nbytes = float(itemsize) * b * h * 64 * rows
    if lse or backward:
        nbytes += 4.0 * b * h * sq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(out, want):
    """max |out - want| and max |want|."""
    return ((out.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


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


# (kernel, case, B, H, Sq, Sk, on the training path). The training shapes:
# global attention of a 12-frame clip at micro-batch 2, the shape encoder
# over 4 096 samples, local attention over 2 x 12 frames; K4 at the
# inference sample count and at a 16-frame window.
GRAD_CASES = [
    ("flash_fwd_lse", "global", 2, 12, 3888, 3888, True),
    ("flash_fwd_lse", "shape_encoder", 2, 12, 64, 4096, True),
    ("folded_fwd_lse", "local", 24, 12, 324, 324, True),
    ("flash_bwd_fused", "global", 2, 12, 3888, 3888, True),
    ("flash_bwd_fused", "shape_encoder", 2, 12, 64, 4096, True),
    ("flash_bwd_fused", "ragged", 1, 4, 1000, 1100, False),
    ("flash_bwd_two_pass", "shape_16k", 2, 12, 64, 16384, False),
    ("flash_bwd_two_pass", "global_t16", 1, 12, 5184, 5184, True),
    ("flash_bwd_two_pass", "ragged", 1, 4, 1000, 4200, False),
    ("folded_bwd", "local", 24, 12, 324, 324, True),
    ("folded_bwd", "ragged", 2, 12, 200, 300, False),
]


def phase_grad_kernels(torch, seed: int) -> list[dict]:
    """The training path's kernels against their plain versions: K1 and K2
    with the LSE output (out and lse), K3, K4 and K5 (dq, dk, dv), each
    within REL_TOL of its own max |plain|, a plain version that drops the
    last 64 keys outside that limit; times beside the bound and, as the
    yardstick, torch's scaled_dot_product_attention (its forward, or its
    backward alone: autograd.grad on a retained graph)."""
    import torch.nn.functional as F
    from motion324_tpu_torch.ops import flash_attention as fa
    from motion324_tpu_torch.ops import folded_attention as fo

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for kname, case, b, h, sq, sk, main in GRAD_CASES:
            folded = kname.startswith("folded")
            if folded:
                # q/k/v as strided views of one fused projection; q is
                # already multiplied by the logit scale 1/8
                qkv = randn(b, max(sq, sk), 3 * h * 64, dtype=dtype)
                q = (qkv[:, :sq, : h * 64] * 0.125).to(dtype)
                k = qkv[:, :sk, h * 64: 2 * h * 64]
                v = qkv[:, :sk, 2 * h * 64:]
                key_axis = 1
                split = lambda x: x.unflatten(-1, (h, 64)).transpose(1, 2)
                plain_fwd = lambda kk, vv: fo.folded_attention_reference(
                    q, kk, vv, heads=h, scale=1.0, with_lse=True)
                kernel_fwd = lambda: fo._forward(q, k, v, h, 1.0, with_lse=True)
                plain_bwd = lambda kk, vv: fo.folded_attention_bwd_reference(
                    q, kk, vv, o, lse, do, heads=h, scale=1.0)
                kernel_bwd = lambda: fo.folded_attention_bwd(q, k, v, o, lse, do,
                                                             heads=h)
            else:
                q = randn(b, h, sq, 64, dtype=dtype, scale=0.125)
                k = randn(b, h, sk, 64, dtype=dtype)
                v = randn(b, h, sk, 64, dtype=dtype)
                key_axis = 2
                split = lambda x: x
                plain_fwd = lambda kk, vv: fa.flash_attention_reference(
                    q, kk, vv, scale=1.0, with_lse=True)
                kernel_fwd = lambda: fa._forward(q, k, v, 1.0, with_lse=True)
                plain_bwd = lambda kk, vv: fa.flash_attention_bwd_reference(
                    q, kk, vv, o, lse, do, scale=1.0)
                kernel_bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)
            drop = lambda x: x.narrow(key_axis, 0, sk - 64)
            o, lse = plain_fwd(k, v)
            do = randn(*o.shape, dtype=dtype)
            if "bwd" in kname:
                outs, wants = kernel_bwd(), plain_bwd(k, v)
                names = ("dq", "dk", "dv")

                def dropped():
                    dq_, dk_, dv_ = plain_bwd(drop(k), drop(v))
                    pad = lambda x: torch.cat(
                        [x, torch.zeros_like(x.narrow(key_axis, 0, 64))], key_axis)
                    return dq_, pad(dk_), pad(dv_)
                run = kernel_bwd
                plain = lambda: plain_bwd(k, v)
                qg, kg, vg = (split(t).detach().clone().requires_grad_()
                              for t in (q, k, v))
                ref = F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
                dref = split(do)
                lib = lambda: torch.autograd.grad(ref, (qg, kg, vg), dref,
                                                  retain_graph=True)
            else:
                outs, wants = kernel_fwd(), (o, lse)
                names = ("out", "lse")
                dropped = lambda: plain_fwd(drop(k), drop(v))
                run = kernel_fwd
                plain = lambda: plain_fwd(k, v)
                lib = lambda: F.scaled_dot_product_attention(
                    split(q), split(k), split(v), scale=1.0)
            torch.cuda.synchronize()
            misses = dropped()
            errs = {}
            for name, out, want, miss in zip(names, outs, wants, misses):
                err, top = rel_err(out, want)
                # the lse is an f32 output in both dtypes
                rel = REL_TOL["float32" if name == "lse" else dname]
                tol = rel * top
                if not (err <= tol):
                    raise AssertionError(f"{kname}/{case} {dname} {name}: max "
                                         f"|kernel - plain| {err:.3e} > {tol:.3e}")
                miss_err = rel_err(miss, want)[0]
                if not (miss_err > tol):
                    raise AssertionError(f"{kname}/{case} {dname} {name}: the "
                                         f"tolerance {tol:.3e} misses a dropped "
                                         f"KV tile ({miss_err:.3e})")
                errs[name] = (err, top, tol, miss_err)
            del outs, wants, misses
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, n=2, reps=3)
            lib_ms = time_ms(torch, lib)
            bound_ms, bound_by = bound(b, h, sq, sk, dname, q.element_size(),
                                       backward="bwd" in kname, lse=True)
            detail = "; ".join(
                f"{n} max|d| {e:.2e} / max|plain| {t:.3g} (tol {tl:.2e}, "
                f"dropped tile {m:.2e})" for n, (e, t, tl, m) in errs.items())
            log(f"  {kname:18s} {case:13s} {dname:8s} B{b} H{h} Sq{sq} Sk{sk}: "
                f"{detail}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa "
                f"{lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})")
            rows.append(dict(kernel=kname, case=case, dtype=dname, main=main,
                             max_abs_err=max(e for e, *_ in errs.values()),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            del q, k, v, o, lse, do
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


def launch_counters(fa, fo) -> dict:
    """Each kernel's launch counter, by name: (wrapper function, attribute)."""
    return {"flash_fwd": (fa.flash_attention, "launches"),
            "flash_fwd_lse": (fa.flash_attention, "lse_launches"),
            "folded_fwd": (fo.folded_attention, "launches"),
            "folded_fwd_lse": (fo.folded_attention, "lse_launches"),
            "flash_bwd_fused": (fa.flash_attention_bwd, "fused_launches"),
            "flash_bwd_two_pass": (fa.flash_attention_bwd, "two_pass_launches"),
            "folded_bwd": (fo.folded_attention_bwd, "launches")}


def read_launches(fa, fo) -> dict:
    return {k: getattr(f, a) for k, (f, a) in launch_counters(fa, fo).items()}


def zero_launches(fa, fo) -> None:
    for f, a in launch_counters(fa, fo).values():
        setattr(f, a, 0)


def patch_backward(cls, make):
    """Replace the backward of autograd Function ``cls`` by ``make(real)``;
    returns a function that restores it. The wrappers' own functions stay
    in place, so their launch counters keep counting."""
    real = cls.backward
    cls.backward = staticmethod(make(real))
    return lambda: setattr(cls, "backward", staticmethod(real))


def launch_spy(fa, fo):
    """Wrap the kernels' forward entry points and the autograd Functions'
    backwards so that each launch is attributed to its call site by the
    shapes it was given: K1 with 64 queries is the shape encoder, any other
    K1 a global layer; K2 over 257 tokens is DINOv2, any other K2 a local
    layer. The counts are the wrappers' own counters, read before and after
    each call. Returns (counts by (kernel, site), a function that removes
    the wrappers)."""
    counts: dict = {}

    def site_of(q, flash):
        if flash:
            return "shape_encoder" if q.shape[2] == 64 else "global"
        return "dino" if q.shape[1] == 257 else "local"

    def spy(real, flash, query):
        def f(*args, **kw):
            before = read_launches(fa, fo)
            out = real(*args, **kw)
            for k, n in read_launches(fa, fo).items():
                if n != before[k]:
                    key = (k, site_of(query(args), flash))
                    counts[key] = counts.get(key, 0) + n - before[k]
            return out
        return f

    def wrap(mod, flash):
        real = mod._forward
        mod._forward = spy(real, flash, lambda a: a[0])
        return lambda: setattr(mod, "_forward", real)

    saved_q = lambda a: a[0].saved_tensors[0]
    undo = [wrap(fa, True), wrap(fo, False),
            patch_backward(fa.FlashAttentionFn, lambda r: spy(r, True, saved_q)),
            patch_backward(fo.FoldedAttentionFn, lambda r: spy(r, False, saved_q))]
    return counts, lambda: [u() for u in undo]


# launches per clip by (kernel, call site): the shape encoder (64 queries x
# 16 384 keys) and 2 windows x 8 global layers on K1; 2 x 8 local layers and
# 2 x 12 DINOv2 layers on K2; no LSE variant and no backward
CLIP_LAUNCHES = {("flash_fwd", "shape_encoder"): 1, ("flash_fwd", "global"): 16,
                 ("folded_fwd", "local"): 16, ("folded_fwd", "dino"): 24}


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
    from motion324_tpu_torch.ops import flash_attention as fa
    from motion324_tpu_torch.ops import folded_attention as fo

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

        torch.cuda.reset_peak_memory_stats()
        zero_launches(fa, fo)
        by_site, undo = launch_spy(fa, fo)
        try:
            out, clip_s = clip("kernel")
        finally:
            undo()
        launches = read_launches(fa, fo)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"  launches in one clip: {launches}; by call site: "
            f"{dict(sorted(by_site.items()))}")
        # 17 K1 and 40 K2, and none of the training kernels
        want = {k: {"flash_fwd": 17, "folded_fwd": 40}.get(k, 0) for k in launches}
        if launches != want or by_site != CLIP_LAUNCHES:
            raise AssertionError(f"main path launches {launches} / {by_site}, "
                                 f"expected {want} / {CLIP_LAUNCHES}")
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
    return by_site


def kernel_group(name: str) -> str:
    """The kernel group of a CUDA kernel's name in a profile."""
    n = name.lower()
    if "flash_fwd" in n:
        return "K1 flash_fwd"
    if "folded_fwd" in n:
        return "K2 folded_fwd"
    if "bwd_dkv_bf16<true, false>" in n or "bwd_dkv_f32<true, false>" in n:
        return "K3 flash_bwd fused"
    if "bwd_dkv_bf16<true, true>" in n or "bwd_dkv_f32<true, true>" in n:
        return "K5 folded_bwd"
    if "bwd_dq_" in n or "bwd_dkv_bf16<false" in n or "bwd_dkv_f32<false" in n:
        return "K4 flash_bwd two-pass"
    if "f32_to_bf16" in n:
        return "K3/K5 dq cast"
    if any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    return "other"


def profile_step(torch, run) -> None:
    """One training step under torch.profiler, device time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the optimizer's annotation spans its kernels: leave it out of the sum
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        log("  profile: the profiler saw no device time (not measured)")
        return
    groups: dict[str, list] = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), [0.0, 0])
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    log(f"  profiled step: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% busy)")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {g:22s} {ms:9.3f} ms {n:6d} launches {100 * ms / busy_ms:5.1f}% "
            f"of device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:100]}")


# launches per micro-batch of one training step at the recipe shapes, by
# (kernel, call site): the shape encoder (64 x 4 096) and 8 global layers
# (3 888 keys) on K1 with the LSE and K3; 8 local layers on K2 with the LSE
# and K5; 12 DINOv2 layers on K2 without the LSE and without a backward
TRAIN_LAUNCHES = {
    ("flash_fwd_lse", "shape_encoder"): 1, ("flash_fwd_lse", "global"): 8,
    ("folded_fwd_lse", "local"): 8, ("folded_fwd", "dino"): 12,
    ("flash_bwd_fused", "shape_encoder"): 1, ("flash_bwd_fused", "global"): 8,
    ("flash_bwd_two_pass", "global"): 0, ("folded_bwd", "local"): 8,
}


def training_batch(torch, seed: int, frames: int = 12, micro: int = 2,
                   points: int = 4096, size: int = 224) -> dict:
    """A seeded synthetic micro-batch at the recipe shapes, on the card:
    shape samples on a blob, supervision points that drift smoothly over
    the frames, and a video in [0, 1]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    pts = rnd(micro, points, 3) * 0.3
    t = torch.linspace(0, 1, frames, device="cuda")[None, :, None, None]
    drift = 0.05 * torch.sin(6.28 * t + pts[:, None, :, :1] * 3)
    return {
        "ref_shape_pcd": rnd(micro, points, 3) * 0.3,
        "ref_shape_normals": torch.nn.functional.normalize(rnd(micro, points, 3), dim=-1),
        "ref_shape_rgbs": torch.rand(micro, points, 3, generator=gen, device="cuda"),
        "ref_pcd": pts,
        "ref_normal": torch.nn.functional.normalize(rnd(micro, points, 3), dim=-1),
        "ref_rgb": torch.rand(micro, points, 3, generator=gen, device="cuda"),
        "rgb_video": torch.rand(micro, frames, size, size, 3, generator=gen,
                                device="cuda"),
        "point_clouds": pts[:, None] + drift,
    }


def step_grads(torch, model, micro_batches, seed: int):
    """Loss, per-parameter gradients (summed over the micro-batches and
    divided by their number, as the train step does) and their global norm,
    with the dropout mask drawn from ``seed``."""
    from motion324_tpu_torch.training.loss import coord_mse_loss
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = None
    loss = 0.0
    for mb in micro_batches:
        l, _ = coord_mse_loss(model(mb, train=True, generator=gen),
                              mb["point_clouds"])
        g = torch.autograd.grad(l, list(params.values()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss += l.item()
    n = len(micro_batches)
    grads = {name: g / n for name, g in zip(params, grads)}
    norm = torch.stack([g.float().pow(2).sum() for g in grads.values()]).sum().sqrt()
    return loss / n, grads, norm.item()


def grad_errors(a: dict, b: dict) -> tuple[float, float, str]:
    """(||a - b|| / ||b|| over all gradients, the largest of the same ratio
    per parameter, that parameter's name)."""
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for name, gb in b.items():
        d = (a[name].float() - gb.float()).norm().item()
        n = gb.float().norm().item()
        num += d * d
        den += n * n
        r = d / n if n > 0 else (0.0 if d == 0 else float("inf"))
        if r > worst:
            worst, worst_name = r, name
    return (num ** 0.5) / (den ** 0.5), worst, worst_name


def backward_faults(torch, fa, fo) -> dict:
    """Wrong backward kernels to inject, by name: (autograd Function, a map
    from its real backward to a faulty one). The global calls are those
    with more than 64 queries (the shape encoder has 64)."""
    def k3_dq_zero(real):
        def f(ctx, do):
            glob = ctx.saved_tensors[0].shape[2] != 64
            dq, dk, dv = real(ctx, do)
            return (torch.zeros_like(dq) if glob else dq), dk, dv
        return f

    def k3_drops_last_tile(real):
        def f(ctx, do):
            glob = ctx.saved_tensors[0].shape[2] != 64
            dq, dk, dv = real(ctx, do)
            if glob:
                dk, dv = dk.clone(), dv.clone()
                dk[:, :, -64:] = 0
                dv[:, :, -64:] = 0
            return dq, dk, dv
        return f

    def k5_dk_low(real):
        def f(ctx, do):
            dq, dk, dv, none = real(ctx, do)
            return dq, dk * 0.9, dv, none
        return f
    return {
        "K3 dq zeroed on the global call": (fa.FlashAttentionFn, k3_dq_zero),
        "K5 dk 10% low": (fo.FoldedAttentionFn, k5_dk_low),
        "K3 drops the last 64 keys from dk/dv": (fa.FlashAttentionFn,
                                                 k3_drops_last_tile),
    }


# kernel path against the plain attention path on one training step, release
# width, bf16 compute, f32 params, relative to the plain path's values:
# "grads" is ||g_kernel - g_plain|| / ||g_plain|| over all gradients,
# "param_grad" the largest of that ratio over the parameters. On an NVIDIA
# H100 80GB HBM3 at 700 W, over seeds 0-3 (seed 0 twice, reading the same),
# the sound readings were at most 3.3e-4 (loss), 4.8e-4 (grad norm), 2.6e-3
# (grads) and 9.8e-3 to 1.1e-2 (param_grad, a q/k-norm or projection weight
# of an attention block); the kernel path against itself, which differs only
# in the order of K3's and K5's dq atomics, read 5.7e-4 to 6.4e-4 (grads)
# and 4.4e-3 to 5.0e-3 (param_grad). The injected backward faults read
# param_grad 1.0 (K3 dq zeroed), 0.10 (K5 dk 10% low) and 0.13-0.23
# (K3 dropping 64 keys), each on an attention q/k-norm weight, whose
# gradient reaches it only through the faulty output; their grads readings
# (4.1e-3 and up) come too close to the sound 2.6e-3 to hold them to. So the
# faults are held to param_grad, whose limit sits 2.7x above the sound
# maximum and 3.4x below the smallest fault; the other limits hold only the
# sound readings, with 2x (grads) to 4x room (PERF.md, Findings).
TRAIN_TOL = {"loss": 2e-3, "grad_norm": 2e-3, "grads": 5e-3, "param_grad": 3e-2}


def phase_training(torch, seed: int) -> dict:
    from motion324_tpu_torch.config import ModelConfig, TrainConfig
    from motion324_tpu_torch.models.motion_model import MotionLatentModel
    from motion324_tpu_torch.ops import flash_attention as fa
    from motion324_tpu_torch.ops import folded_attention as fo
    from motion324_tpu_torch.training.train_step import (create_train_state,
                                                         train_step)

    mcfg = ModelConfig(dtype=torch.bfloat16, decode_frames_chunk=12)
    # the recipe (configs/dyscene.yaml) but for: grad_accum_steps 8 -> 2 to
    # stay inside the smoke's time limit; remat off, so that each kernel
    # launches once per layer (recomputation would repeat the forwards);
    # warmup 1000 -> 0, so that 10 steps move the loss
    tcfg = TrainConfig(grad_accum_steps=2, remat=False, warmup=0, seed=seed)
    log(f"  recipe cut: grad_accum_steps 8 -> {tcfg.grad_accum_steps}, remat "
        f"off, warmup 1000 -> 0; micro-batch {tcfg.batch_size_per_device}, "
        f"{mcfg.frames} frames at {mcfg.image_size}^2, 4096 shape and 4096 "
        f"supervision points, lr {tcfg.lr}, clip {tcfg.grad_clip_norm}, "
        f"spike skip at {tcfg.allowed_gradnorm_factor}x")
    t0 = time.perf_counter()
    model = MotionLatentModel(mcfg, seed=seed).cuda()
    set_layer_scale(torch, model, seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, tcfg)
    log(f"  model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M f32 params")
    micros = [training_batch(torch, seed + 1 + i) for i in range(tcfg.grad_accum_steps)]

    # launches in one step, by the wrappers' counters
    zero_launches(fa, fo)
    step_counts, undo = launch_spy(fa, fo)
    try:
        metrics = train_step(state, micros, tcfg)
        torch.cuda.synchronize()
    finally:
        undo()
    totals = read_launches(fa, fo)
    n = tcfg.grad_accum_steps
    want_sites = {k: v * n for k, v in TRAIN_LAUNCHES.items() if v}
    want_totals = dict.fromkeys(totals, 0)
    for (k, _), v in want_sites.items():
        want_totals[k] += v
    log(f"  launches in one step ({n} micro-batches): {totals}; by call site: "
        f"{dict(sorted(step_counts.items()))}; step metrics {metrics}")
    if totals != want_totals or step_counts != want_sites:
        raise AssertionError(f"training launches {totals} / {step_counts}, "
                             f"expected {want_totals} / {want_sites}")
    del state
    model.load_state_dict(init)

    # the kernel path against the plain attention path, same state and batch
    plain = MotionLatentModel(dataclasses.replace(mcfg, attn_backend="plain"),
                              seed=None).cuda()
    plain.load_state_dict(init)
    plain.image_encoder.requires_grad_(False)
    model.image_encoder.requires_grad_(False)
    loss_k, grads_k, norm_k = step_grads(torch, model, micros, seed)
    loss_p, grads_p, norm_p = step_grads(torch, plain, micros, seed)
    del plain
    torch.cuda.empty_cache()
    total, worst, worst_name = grad_errors(grads_k, grads_p)
    readings = {"loss": abs(loss_k - loss_p) / abs(loss_p),
                "grad_norm": abs(norm_k - norm_p) / norm_p,
                "grads": total, "param_grad": worst}
    log(f"  kernel vs plain path, one step: loss {loss_k:.6f} vs {loss_p:.6f}, "
        f"grad norm {norm_k:.5f} vs {norm_p:.5f}; relative: "
        + ", ".join(f"{k} {v:.3e} (tol {TRAIN_TOL[k]:.0e})" for k, v in readings.items())
        + f"; worst parameter {worst_name}")
    # the same step on the kernel path again: K3 and K5 add dq with atomics,
    # so the two differ only by the order of those sums
    _, grads_r, _ = step_grads(torch, model, micros, seed)
    r_total, r_worst, r_name = grad_errors(grads_r, grads_k)
    del grads_r
    log(f"  kernel path run twice (dq summed in another order): grads "
        f"{r_total:.3e}, worst parameter {r_worst:.3e} ({r_name})")
    # every reading is printed before the phase fails on any of them
    problems = []
    bad = [k for k, v in readings.items() if not v <= TRAIN_TOL[k]]
    if not (r_total <= TRAIN_TOL["grads"] and r_worst <= TRAIN_TOL["param_grad"]):
        bad.append("repeat")
    if bad:
        problems.append(f"kernel path disagrees with the plain path: {bad}")
    missed = []
    for name, (fn_cls, fault) in backward_faults(torch, fa, fo).items():
        undo = patch_backward(fn_cls, fault)
        try:
            loss_f, grads_f, norm_f = step_grads(torch, model, micros, seed)
        finally:
            undo()
        f_total, f_worst, f_name = grad_errors(grads_f, grads_p)
        caught = f_worst > TRAIN_TOL["param_grad"]
        log(f"  injected fault, {name}: grads {f_total:.3e}, worst parameter "
            f"{f_worst:.3e} ({f_name}), grad norm "
            f"{abs(norm_f - norm_p) / norm_p:.3e}: "
            f"{'caught' if caught else 'MISSED'}")
        if not caught:
            missed.append(name)
        del grads_f
    if missed:
        problems.append(f"the tolerances miss injected faults: {missed}")
    del grads_k, grads_p

    # a falling loss on one fixed batch; then the step time. The seeded
    # init's gradient norm (29.5 at seed 0, 23.3 at seed 1) is above the
    # recipe's spike limit of 5 x clip, so from this init the recipe would
    # skip every step: these steps raise the limit to 100 x clip (the clip to
    # 1.0 stays). AdamW's first update moves every weight by about lr; at the
    # peak rate 4e-4 that took the loss from 0.43 to 11.4 (NVIDIA H100 80GB
    # HBM3, 700 W), so these steps run at a constant 2e-7.
    model.load_state_dict(init)
    tcfg = dataclasses.replace(tcfg, allowed_gradnorm_factor=100.0, lr=2e-7)
    log(f"  from here on: spike limit {tcfg.allowed_gradnorm_factor} x clip "
        f"(the init's gradient norm is {metrics['grad_norm']:.2f}), constant "
        f"lr {tcfg.lr}")
    state = create_train_state(model, tcfg)
    losses, skipped = [], []
    for _ in range(10):
        m = train_step(state, micros, tcfg)
        losses.append(m["loss"])
        skipped.append(m["skipped"])
    log(f"  10 steps on one batch: loss {[round(x, 5) for x in losses]}, "
        f"skipped {sum(skipped):.0f}")
    if sum(skipped) or not losses[-1] < losses[0]:
        problems.append(f"loss did not fall without skips: {losses}, "
                        f"skipped {skipped}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, micros, tcfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    samples = tcfg.grad_accum_steps * tcfg.batch_size_per_device
    log(f"  step: median {step_s:.4f} s over 5 ({[round(t, 4) for t in times]}),"
        f" {samples / step_s:.3f} samples/s ({samples} per step), peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    profile_step(torch, lambda: train_step(state, micros, tcfg))

    # K4 on the same model at a 16-frame window: 5 184 global keys
    long_counts, undo = launch_spy(fa, fo)
    try:
        long = training_batch(torch, seed + 7, frames=16)
        m = train_step(state, [long], dataclasses.replace(tcfg, grad_accum_steps=1))
        torch.cuda.synchronize()
    finally:
        undo()
    log(f"  one micro-batch at 16 frames: launches by call site "
        f"{dict(sorted(long_counts.items()))}, metrics {m}")
    if long_counts.get(("flash_bwd_two_pass", "global")) != 8 or any(
            k[0] == "flash_bwd_fused" and k[1] == "global" for k in long_counts):
        problems.append("a 16-frame window must take K4 on its 8 global "
                        f"layers: {long_counts}")
    # the host loop: host batches copied on a side stream, two steps and a
    # checkpoint, then a resume that finds nothing left to do
    from motion324_tpu_torch.training.trainer import Trainer

    def host_batches():
        for i in range(100):
            mbs = [training_batch(torch, seed + 20 + i + j) for j in range(2)]
            yield {k: torch.cat([m[k] for m in mbs]).cpu().numpy()
                   for k in mbs[0]}
    with tempfile.TemporaryDirectory() as tmp:
        tc = dataclasses.replace(tcfg, checkpoint_dir=tmp, print_every=1)
        t0 = time.perf_counter()
        done = Trainer(tc, mcfg, host_batches(), model=model).train(max_steps=2)
        again = Trainer(tc, mcfg, host_batches(), model=model).train(max_steps=2)
        log(f"  Trainer: {done.step} steps and a checkpoint in "
            f"{time.perf_counter() - t0:.1f} s; resumed at step {again.step}")
        if (done.step, again.step, again.update_step) != (2, 2, done.update_step):
            problems.append(f"Trainer: steps {done.step}, resumed at "
                            f"{again.step}")
    # remat, the recipe's setting: each block runs its forward again in the
    # backward, so the LSE forwards launch twice; the gradients stay within
    # the kernel-vs-plain limits (K3/K5 sum dq in a varying order) and the
    # peak memory falls
    peaks, grads, totals = {}, {}, {}
    for remat in (False, True):
        model.remat = remat
        zero_launches(fa, fo)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads[remat] = step_grads(torch, model, micros, seed)[1]
        peaks[remat] = torch.cuda.max_memory_allocated() / 1e9
        totals[remat] = read_launches(fa, fo)
    model.remat = False
    r_total, r_worst, r_name = grad_errors(grads[True], grads[False])
    del grads
    log(f"  remat: peak {peaks[True]:.3f} GB against {peaks[False]:.3f} GB "
        f"without; launches {totals[True]} against {totals[False]}; gradients "
        f"{r_total:.3e}, worst parameter {r_worst:.3e} ({r_name})")
    doubled = {k: v * (2 if k.endswith("_lse") else 1)
               for k, v in totals[False].items()}
    if (totals[True] != doubled or not peaks[True] < peaks[False]
            or not r_total <= TRAIN_TOL["grads"]
            or not r_worst <= TRAIN_TOL["param_grad"]):
        problems.append(f"remat: launches {totals[True]} (want {doubled}), "
                        f"peak {peaks}, gradients {r_total:.3e} / {r_worst:.3e}")
    if problems:
        raise AssertionError("; ".join(problems))
    # the launches the spy counted in one step, and K4's in the 16-frame one
    out = dict(step_counts)
    out[("flash_bwd_two_pass", "global_t16")] = long_counts[
        ("flash_bwd_two_pass", "global")]
    return out


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
    log("== training kernels (LSE forwards, backwards) against their "
        "plain versions")
    rows += phase_grad_kernels(torch, args.seed)
    log("== main path: MotionPipeline.run, release width, bf16")
    launches = phase_pipeline(torch, args.seed, repo)
    log("== training path: train_step, release width, bf16 compute, "
        "f32 params")
    for key, n in phase_training(torch, args.seed).items():
        launches.setdefault(key, n)   # DINOv2's K2 row keeps its clip count

    kernels = []
    for r in rows:
        if not (r["main"] and r["dtype"] == "bfloat16"):
            continue
        kernels.append({
            "name": f"{r['kernel']}/{r['case']}", "route": "cuda",
            "source": "motion324_tpu_torch/csrc/"
                      f"{SOURCES.get(r['kernel'], r['kernel'])}.cu",
            "replaces": REPLACES[r["kernel"]],
            "launches": launches.get((r["kernel"], r["case"])),
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
