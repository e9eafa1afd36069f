"""``BENCHMARK.json`` keeps its rules, every piece a cell names is there,
and a new cell, traffic mix or metric needs new files only."""

import json
import subprocess
import sys

import pytest

import run
from _tiny import BENCH, ROOT, tiny_checkout
from harness import spec


def _bench():
    return spec.load_benchmark(ROOT)


def test_benchmark_keeps_the_rules():
    assert spec.problems(_bench()) == []


@pytest.mark.parametrize("bad", [
    ("workloads", 0, "name", "sage reddit"),
    ("workloads", 0, "name", "sage/reddit"),
    ("end_to_end", 0, "unit", "ms per forward"),
    ("per_layer", 0, "unit", "µs"),
    ("per_layer", 0, "name", "mfu,infer"),
    ("configs", 0, "reduced", ["a b"]),
], ids=str)
def test_problems_catch_bad_names_and_units(bad):
    b = _bench()
    sect, i, key, value = bad
    b[sect][i][key] = value
    assert spec.problems(b)


def test_every_piece_of_every_cell_is_there():
    b = _bench()
    for w in b["workloads"]:
        c = spec.cell(ROOT, w["name"])
        assert (BENCH / "entries" / f"{c.entry}.py").is_file()
        assert c.limits and all(v > 0 for v in c.limits.values())
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
    for sect in ("end_to_end", "per_layer"):
        for m in b[sect]:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in b["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A traffic mix, a cell on it, its limits and a new per-layer metric,
    added as files and entries of ``BENCHMARK.json``: the harness runs the
    cell and reports the metric with no other edit."""
    root = tiny_checkout(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench" / "traffic" / "three-tables.json").write_text(
        json.dumps({"entry": "full_infer", "tables": 3}))
    (root / "perfbench" / "limits" / "sage-ogbn100m.three-tables.json"
     ).write_text(json.dumps({"logit_gap": 1e-4}))
    (root / "perfbench" / "metrics" / "forwards.count.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    b["workloads"].append({"name": "sage-ogbn100m.three-tables",
                           "config": "sage-ogbn100m",
                           "traffic": "three-tables", "chips": 1,
                           "why": "three tables"})
    b["end_to_end"][0]["workloads"].append("sage-ogbn100m.three-tables")
    b["per_layer"].append({"name": "forwards.count", "unit": "forwards",
                           "better": "higher", "source": "host_clock",
                           "layer": "model step", "moves": "full_forward_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert spec.problems(b) == []
    out = run.run_cell(root, "sage-ogbn100m.three-tables", 5, 0.2, True,
                       "cpu", setup_clock=lambda: 1.0)
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["forwards.count"]["value"] == out["attempted"]
    out = run.run_cell(root, "sage-ogbn100m.three-tables", 5, 0.2, False,
                       "cpu", setup_clock=lambda: 1.0)
    assert set(out["metrics"]) == {"full_forward_ms", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    (tmp_path / "perfbench").mkdir()
    for name in ("run.py",):
        (tmp_path / "perfbench" / name).write_text((BENCH / name).read_text())
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json"
                                              ).read_text())
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "sage-reddit.full-infer", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
