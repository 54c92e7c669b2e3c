"""Run one benchmark cell of the PyTorch/CUDA port on the card(s) of this
machine and print its result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiled request after the window). Every run checks
the answers of its window against the plain reference in
``perfbench/reference`` and prints each compared number beside its limit,
last on standard error and under ``compared`` in the result line. Exits
non-zero, printing no result, without enough CUDA devices, outside a
checkout of the repository, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.lib.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
