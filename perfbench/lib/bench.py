"""The harness: finds a cell's files by name, runs its closed loop for the
window, reads the per-layer metrics, checks the answers against the plain
reference and prints the result line.

``BENCHMARK.json`` beside ``perfbench/`` names each cell with its
configuration and chips, the end-to-end metric it reports, and each
per-layer metric with its unit and the cells it is read in; the harness
takes these from there alone. The rest of a cell is
``workloads/<cell>.json`` (its driver, ``drivers/<driver>.py``, its traffic
parameters and the limits of its compared numbers) and
``configs/<config>.json``; a per-layer metric is ``metrics/<metric>.py``,
whose ``read(ctx)`` returns a number or None when it finds nothing to
read. A later change adds a cell, a configuration or a metric by adding
such files and its entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]          # perfbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "motion324_tpu")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"perfbench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    path = root / kind / f"{name}.py"
    key = (f"perfbench_{kind}_{name}_{abs(hash(str(root)))}"
           .replace(".", "_").replace("-", "_"))
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def workload_names(root: Path = ROOT) -> list[str]:
    return sorted(w["name"] for w in benchmark(root)["workloads"])


def end_to_end_of(cell: str, root: Path = ROOT) -> str:
    """The end-to-end metric, besides ``setup_s``, that ``cell`` reports."""
    names = [m["name"] for m in benchmark(root)["end_to_end"]
             if m["name"] != "setup_s" and cell in m.get("workloads", [cell])]
    if len(names) != 1:
        raise SystemExit(f"perfbench: cell {cell} reports {names}, not one "
                         f"end-to-end metric besides setup_s")
    return names[0]


def metrics_for(cell: str, root: Path = ROOT) -> dict:
    """{name: (reader module, unit)} of the per-layer metrics read in
    ``cell``: those that list it, and those without a list that move the
    end-to-end metric it reports."""
    e2e, out = end_to_end_of(cell, root), {}
    for m in benchmark(root)["per_layer"]:
        if cell in m.get("workloads", []) or \
                ("workloads" not in m and m["moves"] == e2e):
            out[m["name"]] = (load_module("metrics", m["name"], root), m["unit"])
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``motion324_tpu_torch`` is not
    ``motion324_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one use of the run's seed."""
    return (abs(int(seed)) * 8 + stream) % (2 ** 63)


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    device: str
    spec: dict          # workloads/<name>.json and the cell's BENCHMARK.json entry
    config: dict        # configs/<config>.json
    tmp: str            # a directory of this run's own

    @property
    def params(self) -> dict:
        return self.spec["traffic_params"]


def set_cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the port's own CUDA libraries
    build into ``motion324_tpu_torch/build/``, also inside it)."""
    cache = CHECKOUT / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str | None = None, config_override: dict | None = None,
             params_override: dict | None = None, control: bool = False,
             root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result object. ``device`` None
    is the card (the run refuses to start without one); the CPU tests pass
    ``"cpu"`` with small overrides. ``control`` (the calibration's runs,
    never the benchmark's) adds the control's readings under
    ``"control"``."""
    import tempfile

    entry = {w["name"]: w for w in benchmark(root)["workloads"]}[name]
    spec = load_json("workloads", name, root)
    config = {**load_json("configs", entry["config"], root), **(config_override or {})}
    spec = {**spec, **entry, "end_to_end": end_to_end_of(name, root),
            "traffic_params": {**spec["traffic_params"], **(params_override or {})}}
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
            raise SystemExit(f"perfbench: cell {name} needs {spec['chips']} CUDA "
                             f"device(s); torch sees "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    driver = load_module("drivers", spec["driver"], root)
    metrics = metrics_for(name, root) if trace else {}
    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmp:
        cell = Cell(name, seed, device, spec, config, tmp)
        state = driver.setup(cell)
        sync(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        note(f"set-up {setup_s:.3f} s")
        times, failed, n = [], 0, 0
        while True:
            a = time.perf_counter()
            try:
                driver.request(state, n)
            except Exception:
                failed += 1
                traceback.print_exc(file=sys.stderr)
            b = time.perf_counter()
            times.append(b - a)
            n += 1
            if b - t0 >= seconds:
                break
        window_s = b - t0
        note(f"window {window_s:.3f} s, {n} requests, {failed} failed; "
             f"seconds a request {[round(x, 4) for x in times]}")
        traced = {}
        if trace:
            t1 = time.perf_counter()
            traced = driver_trace(driver, state, n)
            note(f"traced requests and their reading {time.perf_counter() - t1:.3f} s")
        peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
        ctx = {"requests": n - failed, "window_requests": n,
               "window_s": window_s, "state": state, "driver": driver,
               "trace": traced}
        layer = {}
        for mname, (mod, unit) in metrics.items():
            value = mod.read(ctx)
            if value is not None:
                layer[mname] = {"value": float(value), "unit": unit}
        t1 = time.perf_counter()
        compared, ctl = driver.check(state, control)
        note(f"check against the reference {time.perf_counter() - t1:.3f} s")
        del state, ctx
        gc.collect()
    correct = failed == 0 and all(v <= lim for _, v, lim in compared)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    if trace:
        out_metrics = layer
    else:
        out_metrics = {spec["end_to_end"]: {"value": window_s / max(1, n - failed),
                                             "unit": "s"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if trace and traced:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    if ctl is not None:
        result["control"] = {k: v for k, v, _ in ctl}
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    for k, v, lim in compared:
        print(f"compared {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    return result


def note(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def driver_trace(driver, state, first: int) -> dict:
    """``trace_requests`` more requests under torch.profiler (host and
    device activity), each inside a ``perfbench.request`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.lib import trace
    n = state.cell.params.get("trace_requests", 1)
    acts = [ProfilerActivity.CPU]
    if state.cell.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with driver.trace_spans(state) as names:
        with profile(activities=acts) as prof:
            for i in range(n):
                with record_function(trace.REQUEST):
                    driver.request(state, first + i)
            sync(state.cell.device)
    if state.cell.device != "cuda":
        return {}
    return trace.read(prof.events(), set(names))


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True, choices=workload_names())
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.trace:
        # the port's phase timers print per request when this is set
        # before it is imported
        os.environ["MOTION324_DEBUG"] = "1"
    set_cache_dirs()
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      time.perf_counter() if t_start is None else t_start)
    print(json.dumps(result), flush=True)
    return 0

