"""Spans: the port's one record of where a request's time goes, and the
phase timers and traces built on it.

A span (:func:`span`) is a named region of the program. It records its
name, its id, its parent's id and the id of its root (the outermost span,
one request), its host start and end (``time.perf_counter_ns``) and, where
CUDA is initialised, a pair of timing ``torch.cuda.Event``s on the current
stream at open and close. Closed spans stay in a bounded in-memory buffer;
:func:`spans` returns them resolved (the events are read then, never while
the program runs) and :func:`reset` clears them. A span's device seconds
are the time between its two events; without events, its host seconds.

A device counter (:func:`count`) adds a tensor of counts into a running
sum that stays where the counts are, so the program never waits for it;
:func:`counters` copies every sum to the host once, after a request, and
:func:`reset` clears them.

With ``MOTION324_DEBUG=1`` (read when this module is imported) every span
records, and opens a ``torch.profiler.record_function`` range of its name,
so that the program's spans lie on a profiler trace's clock. Unset, a span
costs a flag test: no record, event, range or clock read, unless its caller
asks for its seconds (``timed=True``), which it then measures on the host
clock alone.

:func:`phase_timer` is a span that also prints its host time, the device
synchronised on the tensors it is given before the clock stops (the port's
copy of ``motion324_tpu/utils/profiling.py``; reference:
scripts/hy3dgen/shapegen/utils.py:38-86 ``synchronize_timer``, gated by
``HY3DGEN_DEBUG=1``). With ``MOTION324_TRACE_DIR`` set as well, a root span
opened with ``trace=True`` (one ``MotionPipeline.run``) is captured by
``torch.profiler`` and written there as a Chrome trace, unless a profiler
is already running.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["span", "phase_timer", "spans", "reset", "SpanRecord",
           "profile_trace", "count", "counters"]

_ENABLED = os.environ.get("MOTION324_DEBUG", "0") == "1"
_TRACE_DIR = os.environ.get("MOTION324_TRACE_DIR")
_TRACE_IDS = itertools.count()

MAX_SPANS = 1 << 14            # closed spans kept; the oldest go first
_DONE: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()      # .stack: this thread's open spans
_EVENTS: list = []             # timing events free for a span to take
_COUNTS: dict = {}             # device counters: name -> running int64 sum
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One closed span, as :func:`spans` returns it."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    device_s: float

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _event():
    try:
        return _EVENTS.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


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


class Span:
    """A span's context manager (see the module's docstring); ``seconds``
    is its host time once it has closed."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "device_s", "_record", "_report", "_sync_on", "_trace",
                 "_capture", "_range", "_events")

    def __init__(self, name: str, record: bool, report: bool = False,
                 sync=None, trace: bool = False):
        self.name, self._record, self._report = name, record, report
        self._sync_on, self._trace = sync, trace
        self._capture = self._range = self._events = None
        self.device_s = None

    def __enter__(self):
        if self._record:
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            parent = stack[-1] if stack else None
            self.id = next(_IDS)
            self.parent = parent.id if parent else None
            self.root = parent.root if parent else self.id
            stack.append(self)
            if self._trace and parent is None and _TRACE_DIR and \
                    not torch._C._autograd._profiler_enabled():
                self._capture = profile_trace(_TRACE_DIR)
                self._capture.__enter__()
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if torch.cuda.is_initialized():
                self._events = (_event(), _event())
                self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            _sync(self._sync_on)
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.perf_counter_ns()
        if self._record:
            self._range.__exit__(*exc)
            _OPEN.stack.pop()
            _DONE.append(self)
            if self._capture is not None:
                self._capture.__exit__(*exc)
        if self._report and exc[0] is None:
            print(f"[motion324 timer] {self.name}: "
                  f"{(self.end_ns - self.start_ns) / 1e6:.1f} ms", flush=True)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def resolved(self) -> SpanRecord:
        if self.device_s is None:
            if self._events is None:
                self.device_s = self.seconds
            else:
                start, end = self._events
                end.synchronize()
                self.device_s = start.elapsed_time(end) / 1e3
                _EVENTS.extend(self._events)
                self._events = None
        return SpanRecord(self.name, self.id, self.parent, self.root,
                          self.start_ns, self.end_ns, self.device_s)


def span(name: str, *, timed: bool = False, trace: bool = False):
    """A span named ``name`` (a context manager). ``timed``: measure its
    host seconds (``.seconds``) even when spans are off. ``trace``: a root
    span written as a Chrome trace under ``MOTION324_TRACE_DIR``."""
    if not (_ENABLED or timed):
        return _OFF
    return Span(name, _ENABLED, trace=trace)


def phase_timer(name: str, sync=None):
    """A span that prints ``[motion324 timer] <name>: <ms> ms``, its host
    time, device-synchronised on ``sync`` (tensors) where given, when
    ``MOTION324_DEBUG=1``."""
    if not _ENABLED:
        return _OFF
    return Span(name, True, report=True, sync=sync)


def spans() -> list[SpanRecord]:
    """The closed spans kept, in the order they closed, their device
    seconds resolved (this waits for each span's closing event)."""
    return [s.resolved() for s in list(_DONE)]


def reset() -> None:
    """Forget every closed span and every device counter."""
    _DONE.clear()
    _COUNTS.clear()


def count(name: str, values: torch.Tensor) -> None:
    """Add ``values`` (integer counts, any shape) to the device counter
    ``name``, on the device that holds them, without a synchronisation.
    Kept while spans record (``MOTION324_DEBUG=1``); else a flag test."""
    if not _ENABLED:
        return
    acc = _COUNTS.get(name)
    if acc is None or acc.shape != values.shape or acc.device != values.device:
        _COUNTS[name] = values.detach().to(torch.int64, copy=True)
    else:
        acc.add_(values)


def counters() -> dict[str, list]:
    """Every device counter's sum on the host (one copy each), as nested
    lists of ints."""
    return {name: acc.tolist() for name, acc in _COUNTS.items()}


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
