"""Production dry run: one rank's step of every (arch × shape × mesh) cell,
traced on fake tensors, with no card.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
compiles each cell for 512 fake devices and reads XLA's memory analysis
and HLO. Here ``specs.build_case`` gives rank 0's blocks of every argument
on a ``TraceMesh`` of the (16, 16) or (2, 16, 16) production mesh as fake
tensors, and ``trace_analysis.analyze`` runs that rank's step on them:
every aten op and every collective the rank would issue, counted, none
computed. It runs on the CPU of any machine (the fake tensors need no
card). Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table  # the records
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape decode_32k --mesh single --breakdown hbm          # or coll

Each cell's record goes to ``build/dryrun/<arch>__<shape>__<mesh>.json``
(an incremental cache keyed by ``VERSION``: a rerun skips green cells):
``n_devices``, ``n_params``, ``n_active_params``, ``trace_s``; ``memory``
(``args_bytes_per_device_exact``: the rank's blocks of the parameters,
optimiser state, batch rows and caches; ``cache_bytes_per_device``;
``peak_bytes_per_device``: the trace's peak live storage, which holds one
train state, since the step updates it in place as the JAX case donates
it, and the whole batch the step receives); ``roofline``
(``launch/roofline.py``'s terms against ``common/hw.py``'s H100 and the
6·N·D / 2·N·D model FLOPs); ``fits_hbm`` (peak ≤ the card's 80 GB);
``collectives`` and the per-op table ``ops``. A failing cell records its
error and traceback, and ``main`` exits 1 if any cell it ran failed.

These are computed numbers, not measurements: the roofline divides by the
H100 SXM5 data sheet's peaks at 700 W, and its collective term by
NVLink's 900 GB/s per card, where a 16-wide ``model`` axis spans two
8-card NVLink domains of HGX H100 nodes and would cross the slower
network between them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.common.config import SHAPES
from repro_torch.common.hw import H100
from repro_torch.common.schema import count_params
from repro_torch.launch import roofline as R
from repro_torch.launch import specs, trace_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "build", "dryrun")
VERSION = "t4"  # bump to invalidate cached cells after code changes
MESHES = {False: "pod16x16", True: "pod2x16x16"}
TOP_OPS = 40    # the per-op table's length in a record


def _path(results_dir: str, arch: str, shape: str, multi_pod: bool) -> str:
    return os.path.join(results_dir,
                        f"{arch}__{shape}__{MESHES[multi_pod]}.json")


def trace_cell(cfg, shape, mesh, tc=None, device=None) -> dict:
    """Trace one rank's step (``specs.build_case``; ``mesh=None``: one
    unsharded device) and return the record's numbers: memory, roofline,
    collectives and the per-op table."""
    t0 = time.time()
    device = device or specs.fake_device()
    case = specs.build_case(cfg, shape, mesh, tc, device=device)
    with case.fake_mode:
        s = trace_analysis.analyze(case.fn, *case.args)
    n_params = count_params(T.model_schema(
        cfg, max_seq=shape.seq_len if cfg.is_encoder_decoder else 0))
    n_active = R.active_params(cfg, n_params)
    n_dev = mesh.size if mesh is not None else 1
    toks = shape.tokens if shape.kind != "decode" else shape.global_batch
    mflops = R.model_flops_estimate(n_params, n_active, shape.kind,
                                    toks / n_dev)
    terms = R.roofline_terms(s.dot_flops, s.hbm_bytes, s.collectives,
                             chip=H100, model_flops=mflops)
    return {"n_devices": n_dev, "n_params": n_params,
            "n_active_params": n_active,
            "trace_s": round(time.time() - t0, 2),
            "fake_device": device,
            "memory": {"args_bytes_per_device_exact": case.arg_bytes,
                       "cache_bytes_per_device": case.cache_bytes,
                       "peak_bytes_per_device": s.peak_bytes,
                       "traced_args_bytes": s.args_bytes},
            "roofline": {**terms.as_dict(), "bound_s": terms.bound_s},
            "fits_hbm": s.peak_bytes <= H100.hbm_bytes,
            "collectives": s.collectives,
            "ops": dict(list(s.ops.items())[:TOP_OPS])}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             results_dir: str = None, force: bool = False,
             verbose: bool = True) -> dict:
    """Rank 0's record of one cell, from the cache in ``results_dir``
    (default ``RESULTS_DIR``) when it holds a green record of this
    ``VERSION`` (unless ``force``), else traced and written there."""
    results_dir = results_dir or RESULTS_DIR
    mesh_name = MESHES[multi_pod]
    os.makedirs(results_dir, exist_ok=True)
    path = _path(results_dir, arch, shape_name, multi_pod)
    if not force and os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("version") == VERSION and prev.get("ok"):
            if verbose:
                print(f"[cache] {arch} × {shape_name} × {mesh_name}")
            return prev

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "rank": 0,
           "version": VERSION, "ok": False}
    try:
        cfg = configs.get_config(arch)
        rec.update(trace_cell(cfg, configs.get_shape(shape_name),
                              make_production_mesh(multi_pod=multi_pod)))
        rec["ok"] = True
        if verbose:
            m, r = rec["memory"], rec["roofline"]
            print(f"[ok] {arch} × {shape_name} × {mesh_name}: "
                  f"{m['peak_bytes_per_device'] / 1e9:.2f} GB/rank peak "
                  f"({m['args_bytes_per_device_exact'] / 1e9:.2f} args), "
                  f"{r['flops'] / 1e9:.1f} GFLOP, coll "
                  f"{r['collective_bytes'] / 1e6:.1f} MB, "
                  f"dominant={r['dominant']} (trace {rec['trace_s']:.0f} s)")
    except Exception as e:  # noqa: BLE001 — record it, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_name}: "
                  f"{rec['error']}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def table(results_dir: str = None) -> str:
    """Every cell of ``configs.cells()`` as a markdown table row, the
    (16, 16) mesh's number before the (2, 16, 16) one's in each column
    (the counterpart of ``scripts/make_experiments.py``)."""
    results_dir = results_dir or RESULTS_DIR
    gb = lambda n: f"{n / 1e9:.2f}"  # noqa: E731
    cols = (
        ("peak GB / rank", lambda r: gb(r["memory"]["peak_bytes_per_device"])),
        ("args GB / rank",
         lambda r: gb(r["memory"]["args_bytes_per_device_exact"])),
        ("fits 80 GB", lambda r: "yes" if r["fits_hbm"] else "no"),
        ("GFLOP", lambda r: f"{r['roofline']['flops'] / 1e9:.1f}"),
        ("collective MB",
         lambda r: f"{r['roofline']['collective_bytes'] / 1e6:.1f}"),
        ("dominant", lambda r: r["roofline"]["dominant"]),
        ("bound ms", lambda r: f"{r['roofline']['bound_s'] * 1e3:.2f}"))
    rows = ["| arch | shape | " + " | ".join(c for c, _ in cols) + " |",
            "|---|---|" + "---|" * len(cols)]
    for arch, shape in configs.cells():
        recs = []
        for mp in (False, True):
            path = _path(results_dir, arch, shape, mp)
            rec = None
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            recs.append(rec)
        cells = []
        for _, fmt in cols:
            cells.append(" · ".join(
                "not run" if r is None else
                fmt(r) if r.get("ok") else
                "failed" for r in recs))
        rows.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def breakdown(rec: dict, mode: str) -> str:
    """One record's top ops by bytes (``hbm``) or its collectives by name
    (``coll``): the counterpart of ``scripts/hbm_breakdown.py``."""
    if mode == "coll":
        items = sorted(rec["collectives"].items(),
                       key=lambda kv: -kv[1]["bytes"])
        return "\n".join(f"{k:20s} {int(v['count']):8d} calls "
                         f"{v['bytes'] / 1e6:12.1f} MB" for k, v in items)
    return "\n".join(f"{k:28s} {int(v['calls']):8d} calls "
                     f"{v['bytes'] / 1e9:10.3f} GB {v['flops'] / 1e9:12.1f} "
                     f"GFLOP" for k, v in rec["ops"].items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the recorded cells as a markdown table")
    ap.add_argument("--breakdown", choices=["hbm", "coll"],
                    help="one cell's top ops by bytes, or its collectives")
    ap.add_argument("--results-dir", default=None,
                    help=f"where the records go (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    cell_list = configs.cells()
    if args.list:
        for a, s in cell_list:
            print(f"{a:24s} {s}")
        print(f"{len(cell_list)} runnable cells "
              f"({len(configs.SKIP_CELLS)} documented skips)")
        return 0
    if args.table:
        print(table(args.results_dir))
        return 0

    archs = configs.ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.breakdown and (len(archs) != 1 or len(shapes) != 1
                           or len(meshes) != 1):
        ap.error("--breakdown needs one --arch, one --shape and --mesh "
                 "single or multi")

    failures = 0
    for arch in archs:
        for shape in shapes:
            if (arch, shape) in configs.SKIP_CELLS:
                print(f"[skip] {arch} × {shape}: "
                      f"{configs.SKIP_CELLS[(arch, shape)]}")
                continue
            for mp in meshes:
                rec = run_cell(arch, shape, mp, results_dir=args.results_dir,
                               force=args.force)
                failures += 0 if rec.get("ok") else 1
                if args.breakdown and rec.get("ok"):
                    print(breakdown(rec, args.breakdown))
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
