"""What the per-layer metric files share: means over the window's
requests of the program's phase timers and of the harness's spans, the
share of the peak (the driver counts a request's FLOPs), K1's share of its
roofline (the driver lists a request's K1 calls) and the device's idle
share. Each returns None where the run has nothing to read."""

from __future__ import annotations

from perfbench.lib.peaks import PEAK_FLOPS, bound_s


def mean_of(records: list, names, ctx) -> float | None:
    """Mean over the window's requests of the summed ``names`` in each
    record (a dict of seconds per request)."""
    rows = records[:ctx["window_requests"]]
    vals = [sum(r[n] for n in names) for r in rows if all(n in r for n in names)]
    return sum(vals) / len(vals) if vals else None


def mfu(ctx) -> float | None:
    """Model FLOPs a request over its mean wall seconds in the window
    (profiler off), as a share of the card's bf16 peak, in %."""
    if not ctx["requests"]:
        return None
    per_request_s = ctx["window_s"] / ctx["requests"]
    work = ctx["driver"].request_flops(ctx["state"])
    return 100.0 * work / per_request_s / PEAK_FLOPS["bfloat16"]


def kernel_s(ctx, pattern: str) -> float | None:
    """Device seconds a traced request of kernels whose name holds
    ``pattern``."""
    tr = ctx["trace"]
    if not tr:
        return None
    total = sum(s for name, s in tr["kernels"] if pattern in name)
    n = ctx["state"].cell.params.get("trace_requests", 1)
    return total / n if total > 0 else None


def k1_roofline(ctx) -> float | None:
    """The least time of a request's K1 calls (the driver's ``k1_calls``)
    over K1's device time a traced request, in %."""
    spent = kernel_s(ctx, "k1_flash_fwd")
    if spent is None:
        return None
    least = sum(c * bound_s(b, h, sq, sk, d)
                for c, b, h, sq, sk, d in ctx["driver"].k1_calls(ctx["state"]))
    return 100.0 * least / spent


def device_idle(ctx) -> float | None:
    """1 - (the union of kernel intervals a traced request) / (the wall
    seconds a request in the window, profiler off), in %. The profiler's
    host-side recording slows the launches of a traced request, so its own
    window would overstate the idle share."""
    tr = ctx["trace"]
    if not tr or not ctx["requests"]:
        return None
    busy = tr["busy_s"] / ctx["state"].cell.params.get("trace_requests", 1)
    return 100.0 * (1.0 - busy / (ctx["window_s"] / ctx["requests"]))
