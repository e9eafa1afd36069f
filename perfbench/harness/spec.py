"""``BENCHMARK.json`` and the files it names, found by name.

A cell is one entry of ``workloads``. Its pieces are files of their own:

* the configuration: the ``file`` of its ``configs`` entry (a JSON object
  with the model's widths, the graph's scale and the precision);
* the traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``entry``
  names the program call the window drives,
  ``perfbench/entries/<entry>.py``;
* the limits of the numbers that decide ``correct``:
  ``perfbench/limits/<cell>.json``;
* each metric: ``perfbench/metrics/<metric>.py``, a reader with
  ``read(ctx)`` that returns a number or ``None``.

So a new cell, traffic mix, configuration or metric is a new file and a new
entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = "perfbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE_RE = re.compile(r"^[^\t\r\n]{1,200}$")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell needs, read from the files."""
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` belongs to ``cell``: listed there by its
    ``workloads``, or, without that key, an end-to-end metric (every cell)
    or a per-layer metric whose ``moves`` the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(root: Path, name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a name the file does not hold."""
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / BENCH_DIR / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, config, traffic, int(w["chips"]),
                {k: float(v) for k, v in limits.items()}, e2e, layer, root)


def load_module(path: Path, qualname: str):
    """Import the file at ``path`` as a module named ``qualname`` (file
    names may hold dots, so they are loaded by path), once."""
    known = sys.modules.get(qualname)
    path = Path(path).resolve()
    if known is not None and Path(known.__file__).resolve() == path:
        return known
    spec = importlib.util.spec_from_file_location(qualname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[qualname] = mod
    return mod


def entry_module(c: Cell):
    return load_module(c.root / BENCH_DIR / "entries" / f"{c.entry}.py",
                       f"perfbench_entry_{c.entry}")


def metric_reader(root: Path, metric: str):
    return load_module(Path(root) / BENCH_DIR / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + re.sub(r"\W", "_", metric))


def problems(bench: dict) -> List[str]:
    """What in ``bench`` breaks the file's rules on keys, names, units and
    text; empty when it keeps them."""
    out = []

    def need(ok, msg):
        if not ok:
            out.append(msg)

    need(set(bench) == TOP_KEYS, f"top-level keys {sorted(bench)}")
    names = []
    for c in bench.get("configs", []):
        need(set(c) == CONFIG_KEYS, f"config keys {sorted(c)}")
        need(bool(PATH_RE.match(c.get("file", ""))), f"file {c.get('file')}")
        need(len(c.get("reduced", [])) <= 16, "reduced has over 16 keys")
        for k in c.get("reduced", []):
            need(bool(NAME_RE.match(k)), f"reduced key {k!r}")
        for k in ("source", "why"):
            need(bool(LINE_RE.match(c.get(k, ""))), f"config {k} {c.get(k)!r}")
        names.append(("config", c.get("name", "")))
    pairs = set()
    for w in bench.get("workloads", []):
        need(set(w) == WORKLOAD_KEYS, f"workload keys {sorted(w)}")
        need(w.get("chips") in (1, 4), f"chips {w.get('chips')}")
        need(bool(LINE_RE.match(w.get("why", ""))), f"why {w.get('why')!r}")
        for k in ("config", "traffic"):
            need(bool(NAME_RE.match(w.get(k, ""))), f"{k} {w.get(k)!r}")
        pair = (w.get("config"), w.get("traffic"))
        need(pair not in pairs, f"config and traffic twice: {pair}")
        pairs.add(pair)
        names.append(("workload", w.get("name", "")))
    for sect, keys in (("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for m in bench.get(sect, []):
            need(set(m) - {"workloads"} == keys, f"{sect} keys {sorted(m)}")
            need(bool(UNIT_RE.match(m.get("unit", ""))),
                 f"unit {m.get('unit')!r}")
            need(m.get("better") in ("lower", "higher"),
                 f"better {m.get('better')}")
            need(m.get("source") in SOURCES, f"source {m.get('source')}")
            if sect == "per_layer":
                need(bool(LINE_RE.match(m.get("layer", ""))),
                     f"layer {m.get('layer')!r}")
            names.append(("metric", m.get("name", "")))
    for kind, n in names:
        need(bool(NAME_RE.match(n)), f"{kind} name {n!r}")
    for kind in ("config", "workload", "metric"):
        got = [n for k, n in names if k == kind]
        need(len(got) == len(set(got)), f"two {kind}s share a name")
    for word in bench.get("command", []):
        need(bool(LINE_RE.match(word)), f"command word {word!r}")
    for p in bench.get("paths", []):
        need(bool(PATH_RE.match(p)) and not p.startswith("/")
             and ".." not in p.split("/"), f"path {p!r}")
    return out
