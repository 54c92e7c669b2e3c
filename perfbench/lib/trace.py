"""Reading a ``torch.profiler`` capture: device busy time as the union of
kernel intervals, device time by kernel name, and the device's idle gaps
labelled by what the host was doing (the innermost annotated range, then
the innermost host operation, at the gap's midpoint)."""

from __future__ import annotations

import bisect
from collections import defaultdict

REQUEST = "perfbench.request"
SMALL_GAP_US = 20.0        # gaps shorter than this are launch gaps


def _device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() == "CUDA"


def read(events, annotations: set[str]) -> dict:
    """``events``: ``prof.events()``; ``annotations``: the names of the
    ranges the harness and the program's spans opened. Returns the traced
    window (from the first request's start to the last one's end), the
    kernels inside it, the busy seconds and the two breakdown lists."""
    cpu_ranges, ops, kernels = [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if _device(e):
            if e.name in annotations or e.name == REQUEST \
                    or getattr(e, "is_user_annotation", False):
                continue
            kernels.append((start, end, e.name))
        elif e.name == REQUEST or e.name in annotations:
            cpu_ranges.append((start, end, e.name))
        else:
            ops.append((start, end, e.name))
    requests = [r for r in cpu_ranges if r[2] == REQUEST]
    if not requests or not kernels:
        return {}
    w0, w1 = min(r[0] for r in requests), max(r[1] for r in requests)
    kernels = sorted(k for k in kernels if k[1] > w0 and k[0] < w1)
    busy, gaps, edge = 0.0, [], w0
    by_name: dict[str, float] = defaultdict(float)
    for s, e, name in kernels:
        s, e = max(s, w0), min(e, w1)
        by_name[name] += e - s
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    labels = _labeller(cpu_ranges, ops)
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        name = labels((a + b) / 2) if b - a >= SMALL_GAP_US else \
            f"launch gaps under {SMALL_GAP_US:g} us"
        idle[name] += b - a
    top = lambda d: [[k[:160], v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernels": [(n, (e - s) / 1e6) for s, e, n in kernels],
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _labeller(ranges, ops):
    ranges = sorted(r for r in ranges if r[2] != REQUEST)
    ops = sorted(ops)
    r_starts = [r[0] for r in ranges]
    o_starts = [o[0] for o in ops]

    def innermost(items, starts, t, depth):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - depth), -1):
            if items[j][1] >= t:
                return items[j][2]
        return None

    def label(t):
        where = innermost(ranges, r_starts, t, len(ranges)) or "between spans"
        op = innermost(ops, o_starts, t, 64) or "no device op (Python on the host)"
        return f"{where} / {op}"
    return label
