"""Import checks in fresh interpreters, for tests/test_torch_isolation.py.

Each check runs in a process forked from a ``forkserver`` whose only
preloads are ``torch`` and ``numpy``: the child starts with nothing of the
port (or of JAX) loaded, imports its modules, and reports which of a list
of top-level packages are then in ``sys.modules``, and which of its
``checks`` found something built or started at import. A case thus pays for
its own imports only, not for a whole interpreter that imports torch. This
module imports nothing beyond the standard library.
"""

from __future__ import annotations

import multiprocessing
import sys

_ctx = None


def _context():
    global _ctx
    if _ctx is None:
        _ctx = multiprocessing.get_context("forkserver")
        _ctx.set_forkserver_preload(["torch", "numpy"])
    return _ctx


def _native_built() -> bool:
    from motion324_tpu_torch import native
    return native._lib is not None


def _kernel_built() -> bool:
    from motion324_tpu_torch.ops import _build
    return bool(_build._libs)


def _group_started() -> bool:
    import torch.distributed as dist
    return dist.is_initialized()


CHECKS = {"native": _native_built, "kernels": _kernel_built,
          "process_group": _group_started}


def _probe(conn, modules, forbidden, checks) -> None:
    try:
        early = sorted(m for m in sys.modules if m.split(".")[0] in
                       forbidden + ("motion324_tpu_torch", "chip_smoke"))
        for m in modules:
            __import__(m)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
        conn.send({"bad": bad, "early": early,
                   "built": [c for c in checks if CHECKS[c]()]})
    except BaseException as e:   # report, do not hang the parent
        conn.send({"error": f"{type(e).__name__}: {e}"})
    finally:
        conn.close()


def probe(modules: list[str], forbidden: tuple[str, ...],
          checks: tuple[str, ...] = (), timeout: float = 120.0) -> dict:
    """Import ``modules`` in a fresh forked interpreter; returns ``bad``
    (the loaded modules whose top-level package is in ``forbidden``),
    ``early`` (such modules, or the port's, that were loaded before the
    imports: none, if the child is fresh) and ``built`` (the ``checks``
    that found something), or ``error``."""
    ctx = _context()
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_probe, args=(send, list(modules),
                                            tuple(forbidden), tuple(checks)))
    proc.start()
    send.close()
    try:
        if not recv.poll(timeout):
            raise TimeoutError(f"importing {modules} took over {timeout} s")
        return recv.recv()
    finally:
        recv.close()
        proc.join(10)
        if proc.is_alive():
            proc.kill()
