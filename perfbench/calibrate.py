"""The readings the limits of ``correct`` are set from, for one cell, at
the cell's own size, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 0] [--out FILE]

For each seed: the set-up, a window of ``--seconds`` (0: one request), and
the program's numbers against the plain reference (the lower reading);
on the control seeds also the control's numbers (the reference in float8
e4m3 against the float32 reference: the upper reading). One JSON line per
seed on standard output, and in ``--out``. The benchmark's own runs never
run the control.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.lib import bench  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, choices=bench.workload_names())
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    bench.set_cache_dirs()
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    t0 = T_START
    for seed in (int(s) for s in a.seeds.split(",")):
        r = bench.run_cell(a.workload, seed, a.seconds, False, t0,
                           control=seed in ctl)
        line = {"workload": a.workload, "seed": seed, "correct": r["correct"],
                "compared": {k: v["value"] for k, v in r["compared"].items()},
                "control": r.get("control"), "attempted": r["attempted"],
                "metrics": r["metrics"], "memory_peak_bytes":
                r["device"]["memory_peak_bytes"], "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
