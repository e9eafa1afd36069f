"""A copy of the benchmark at tiny sizes, for runs on the CPU."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {"sage-reddit": dict(scale=8, edge_factor=4, F=20, H=16, C=5),
        "sage-ogbn100m": dict(scale=8, edge_factor=6, F=8, H=16, C=7)}


def tiny_checkout(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``perfbench`` (without its
    tests) with every configuration cut to a few hundred vertices; the
    widths are kept apart so that the pad and the narrow path both run."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, t in TINY.items():
        p = dest / "perfbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["graph"].update(scale=t["scale"], edge_factor=t["edge_factor"])
        c["vertices"] = 1 << t["scale"]
        c["edges"] = t["edge_factor"] << t["scale"]
        c["model"].update(n_features=t["F"], hidden=t["H"], n_classes=t["C"])
        p.write_text(json.dumps(c))
    return dest


def scaled_checkout(dest: Path, scale: int) -> Path:
    """``dest`` holding the benchmark with every graph cut to 2^scale
    vertices at its own edge factor and every width as published."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for p in (dest / "perfbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["graph"]["scale"] = scale
        c["vertices"] = 1 << scale
        c["edges"] = c["graph"]["edge_factor"] << scale
        p.write_text(json.dumps(c))
    return dest
