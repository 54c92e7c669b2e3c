"""What the span-based per-layer metric files share: the port's own span
record (``motion324_tpu_torch.utils.profiling.spans()``, kept while
``MOTION324_DEBUG=1``, which ``--trace 1`` sets), cut to the window's
requests. The roots of a request's outermost span come in the order
set-up (the warm-up), window, traced requests: the window's are the
``window_requests`` roots before the last ``trace_requests``. Each returns
None where the program keeps no such record (a port without
``profiling.spans``) or the window has none of the named spans."""

from __future__ import annotations


def _window(ctx, root: str):
    """(the window's root ids, every span kept), or None."""
    from motion324_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    records = read()
    roots = sorted(r.id for r in records if r.parent is None and r.name == root)
    n = ctx["window_requests"]
    k = ctx["state"].cell.params.get("trace_requests", 1)
    ids = set(roots[max(0, len(roots) - n - k):len(roots) - k])
    return (ids, records) if ids else None


def per_request(ctx, root: str, names, device: bool = True) -> float | None:
    """Mean over the window's requests (roots named ``root``) of the
    seconds of their spans named ``names``, summed a request: device
    seconds (the span's timing events on the card), else host seconds."""
    got = _window(ctx, root)
    if got is None:
        return None
    ids, records = got
    sums: dict[int, float] = {}
    for r in records:
        if r.root in ids and r.name in names:
            sums[r.root] = sums.get(r.root, 0.0) + (r.device_s if device
                                                    else r.host_s)
    return sum(sums.values()) / len(sums) if sums else None


def per_span(ctx, root: str, name: str) -> float | None:
    """Mean device seconds of the spans named ``name`` in the window's
    requests (roots named ``root``)."""
    got = _window(ctx, root)
    if got is None:
        return None
    ids, records = got
    vals = [r.device_s for r in records if r.root in ids and r.name == name]
    return sum(vals) / len(vals) if vals else None
