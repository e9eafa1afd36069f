"""No process of the benchmark loads JAX or the JAX package: the names are
compared by whole top-level name, and the harness, the reference, the
entries and the metrics import neither."""

import os
import subprocess
import sys

import run
from _tiny import BENCH, ROOT


def test_foreign_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "repro", "repro.core.gcn", "repro_torch", "repro_torch.core",
             "jaxtyping", "reproduce", "torch"]
    assert run.foreign_modules(names) == ["flax", "jax", "jaxlib", "repro"]
    assert run.foreign_modules(["repro_torch.core.gcn", "torch"]) == []


def test_the_benchmark_loads_no_jax():
    code = (
        "import sys, pathlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}]\n"
        "import run, control\n"
        "from harness import spec, faults, inputs, trace, readers\n"
        "from reference import gcn\n"
        "root = pathlib.Path(run.ROOT)\n"
        "b = spec.load_benchmark(root)\n"
        "for w in b['workloads']:\n"
        "    spec.entry_module(spec.cell(root, w['name']))\n"
        "for s in ('end_to_end', 'per_layer'):\n"
        "    for m in b[s]:\n"
        "        spec.metric_reader(root, m['name'])\n"
        "print(run.foreign_modules(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_file_of_the_benchmark_reads_the_old_benchmarks_folder():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text
