"""What the benchmark runs imports neither JAX nor the JAX package, and its
reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*parts):
    return [p for p in ROOT.joinpath(*parts).rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported_tops(path) & {"jax", "jaxlib", "flax", "motion324_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert "motion324_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "json", "math", "struct",
                        "numpy", "scipy", "torch", "perfbench"}, (path, tops)
    for path in sources("reference"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("perfbench."):
                assert node.module.startswith("perfbench.reference"), path


def test_importing_the_harness_and_reference_loads_no_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.lib.bench, perfbench.lib.flops, perfbench.lib.readers\n"
            "import perfbench.reference.pipelines, perfbench.lib.weights\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'motion324_tpu', 'motion324_tpu_torch')]\n"
            "assert not bad, bad\n") % str(ROOT.parent)
    subprocess.run([sys.executable, "-c", code], check=True)


def test_a_run_outside_a_checkout_exits_without_a_result(tmp_path):
    import shutil
    shutil.copytree(ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "shape-latents50", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert not p.stdout.strip().endswith("}")
