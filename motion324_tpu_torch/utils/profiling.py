"""Profiling and tracing: phase timers and torch.profiler traces, gated by
environment variables.

The port's copy of ``motion324_tpu/utils/profiling.py`` (reference:
scripts/hy3dgen/shapegen/utils.py:38-86 ``synchronize_timer``, gated by
``HY3DGEN_DEBUG=1``). With ``MOTION324_DEBUG=1`` each timed region prints
its wall time, the device synchronised on the tensors it is given (a
``torch.cuda.synchronize`` of their devices) before the clock stops; with
``MOTION324_TRACE_DIR`` set as well, each timed region is also captured by
``torch.profiler`` and written there as a Chrome trace. Unset, the timers
cost a flag test.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time

import torch

__all__ = ["phase_timer", "timed", "profile_trace"]

_ENABLED = os.environ.get("MOTION324_DEBUG", "0") == "1"
_TRACE_DIR = os.environ.get("MOTION324_TRACE_DIR")
_TRACE_IDS = itertools.count()


def _sync(tree) -> None:
    """Synchronise every CUDA device that holds a tensor of ``tree`` (a
    tensor, or a list, tuple or dict of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


def _report(name: str, t0: float) -> None:
    print(f"[motion324 timer] {name}: "
          f"{(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)


@contextlib.contextmanager
def phase_timer(name: str, sync=None):
    """Context manager: the wall time of a phase, device-synchronised on
    ``sync`` (tensors) where given, printed when ``MOTION324_DEBUG=1``; a
    trace of it under ``MOTION324_TRACE_DIR`` when that is set."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    with profile_trace(_TRACE_DIR) if _TRACE_DIR else contextlib.nullcontext():
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
    _report(name, t0)


def timed(name: str):
    """Decorator form of :func:`phase_timer`, synchronised on the return
    value."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(out)
            _report(name, t0)
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` capture of the region (CPU, and CUDA where a
    card is present), written to ``log_dir`` as a Chrome trace
    ``trace_<pid>_<n>.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json"))
