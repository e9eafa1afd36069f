"""The counted rows of ``BENCH_collective_bytes.json``, reproduced by the
port.

The JAX package's ``benchmarks/collective_bytes.py`` writes that file from
compiled XLA HLO, jaxpr counts and host counters. This module runs the
port on the same numpy-seeded graphs and features and produces the same
fields for every counter row (37: sampled 10, wire 6, skip_rate 4,
coalesce 4, full 3, sparse 3, partition 2, coalesce_grad 2, serving 2,
serving_cache 1) and the summary's counted fields, then holds them
against the committed file: every non-timing field must be equal. The
file's timing rows (``agg_time``, ``train_step_time``, ``sched_build``)
and timing ratios are interpreter times of the JAX package and are never
produced or compared.

Bytes follow the committed file's convention: per rank, the larger of the
input and output bytes of each collective
(``core.collectives.count_collectives``). Each value of ``ways`` (2, 4,
8) is one ``spawn`` of that many gloo ranks on ``--device``, which runs
all of that width's rows (the host-only rows ride rank 0 of the 8-way
group). A field the port cannot match because XLA's compiled program
differs from what any call ships is listed in ``DIVERGENT`` with the
reason; it is reported, not loosened.

    python -m repro_torch.analysis.counted_rows [--device cuda|cpu] [--out PATH]

writes the rows to ``--out`` (default ``build/counted_rows.json``) and
exits 1 on drift, naming each field with both values. It reads the
committed file and never writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.counts import count_run

ROOT = Path(__file__).resolve().parents[3]
COMMITTED = ROOT / "BENCH_collective_bytes.json"
FLOWS = ("baseline", "cgtrans")
PAPER_K = 50          # paper §4.2: GraphSAGE samples 50 neighbours
PAPER_MIN_RATIO = 30  # the ≈50× claim, with slack for collective overheads
WIDTHS = (2, 4, 8)
TIMEOUT_S = 900

# -- the drift check: the row key and comparison of the JAX package's
# -- bench-drift gate, with every counter row required ---------------------

#: row modes that are wall-clock measurements — never compared
TIMING_MODES = {"agg_time", "sched_build", "train_step_time"}

#: wall-clock fields that may appear on otherwise-counted rows
TIMING_FIELDS = {"us", "us_per_shard", "loss"}

#: fields that identify a row (the sweep parameters); every other field
#: of the row is a measured claim and must match exactly
ID_FIELDS = {
    "mode", "ways", "K", "F", "V", "E", "B_loc", "part", "N", "waves",
    "fanout", "wire", "flow", "form", "impl", "scheduled", "graph",
    "method", "target_density", "paper_figure",
}

#: the summary's counted fields, compared exactly
COUNTED_SUMMARY = (
    "max_ratio", "paper_figure_ratio", "clustered_skipped_rounds",
    "coalesce_collectives_separate", "coalesce_collectives_coalesced",
    "partition_remote_rows", "partition_dense_live_rounds",
    "serving_finds_per_query", "serving_collectives_per_query",
    "serving_cache_hit_rate", "wire_ratios_K50_F128", "sparse_a2a_ratios",
)

#: (row key, field) → why the committed value comes from a program no call
#: of the port ships; compared and reported, never counted as drift
_FOLDED = (
    "the JAX bench closes over constant request blocks in the separate "
    "form, and XLA constant-folds its two request all_gathers (8 ranks x "
    "(32 + 320) int32 ids = 11264 B) out of the compiled program; the port "
    "ships them, as the JAX program does when the requests are arguments "
    "(its compiled HLO then holds the same 11264 B more)")
DIVERGENT: Dict[Tuple[tuple, str], str] = {
    ((("F", 64), ("flow", flow), ("form", "separate"), ("mode", "coalesce"),
      ("ways", 8)), "bytes"): _FOLDED
    for flow in FLOWS}


def row_key(row: dict) -> tuple:
    return tuple(sorted((k, row[k]) for k in row if k in ID_FIELDS))


def fmt_key(key) -> str:
    return " ".join(f"{k}={v}" for k, v in key)


def compare(fresh: dict, committed: dict):
    """(drift, divergent): each entry (where, field, committed, fresh).
    A committed counter row the run did not produce is drift; so is a
    ``DIVERGENT`` field whose values agree (the table is stale)."""
    drift, divergent = [], []
    f_rows = {row_key(r): r for r in fresh.get("rows", [])
              if r.get("mode") not in TIMING_MODES}
    c_rows = {row_key(r): r for r in committed.get("rows", [])
              if r.get("mode") not in TIMING_MODES}
    for k in sorted(set(c_rows) - set(f_rows)):
        drift.append((fmt_key(k), "<row>", "present", "missing"))
    for k in sorted(set(f_rows) - set(c_rows)):
        drift.append((fmt_key(k), "<row>", "missing", "present"))
    for k in sorted(set(f_rows) & set(c_rows)):
        fr, cr = f_rows[k], c_rows[k]
        for field in sorted((set(fr) | set(cr)) - ID_FIELDS - TIMING_FIELDS):
            fv, cv = fr.get(field), cr.get(field)
            entry = (fmt_key(k), field, cv, fv)
            if (k, field) in DIVERGENT:
                (divergent if fv != cv else drift).append(entry)
            elif fv != cv:
                drift.append(entry)
    fs, cs = fresh.get("summary", {}), committed.get("summary", {})
    for key in COUNTED_SUMMARY:
        if fs.get(key) != cs.get(key):
            drift.append(("summary", key, cs.get(key), fs.get(key)))
    return drift, divergent


# -- the rows ---------------------------------------------------------------

def _mine(mesh, x):
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.rank:mesh.rank + 1])).to(mesh.device)


def _zeros(mesh, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=mesh.device)


def _ones(mesh, *shape):
    return torch.ones(shape, dtype=torch.bool, device=mesh.device)


def bench_sampled(mesh, K: int, F: int, B_loc: int = 32,
                  part: int = 64) -> dict:
    """Sampled GraphSAGE aggregation: B_loc seeds per rank, fan-out K."""
    from repro_torch.core import cgtrans
    feats = _zeros(mesh, 1, part, F)
    nbrs = _zeros(mesh, 1, B_loc, K, dtype=torch.int32)
    mask = _ones(mesh, 1, B_loc, K)
    row = {"mode": "sampled", "ways": mesh.size, "K": K, "F": F,
           "B_loc": B_loc, "part": part}
    for flow in FLOWS:
        run = count_run(lambda f, n, m: cgtrans.aggregate_sampled(
            f, n, m, mesh=mesh, dataflow=flow), feats, nbrs, mask)
        row[flow] = float(sum(run.bytes.values()))
    row["ratio"] = row["baseline"] / row["cgtrans"] if row["cgtrans"] else 0.0
    return row


def bench_full_graph(mesh, F: int, V: int = 256, E: int = 4096) -> dict:
    """Full-graph edge COO aggregation on a partitioned uniform graph."""
    from repro_torch.core import cgtrans
    from repro_torch.graph import partition_by_src, uniform_graph
    g = uniform_graph(V, E, seed=1, n_features=F, weights=True)
    pg = partition_by_src(g, mesh.size)
    args = [_mine(mesh, a) for a in (pg.features, pg.src, pg.dst,
                                     pg.weights, pg.mask)]
    row = {"mode": "full", "ways": mesh.size, "V": V, "E": E, "F": F,
           "avg_fanin": E / V}
    for flow in FLOWS:
        run = count_run(lambda *a: cgtrans.aggregate_edges(
            *a, mesh=mesh, dataflow=flow), *args)
        row[flow] = float(sum(run.bytes.values()))
    row["ratio"] = row["baseline"] / row["cgtrans"] if row["cgtrans"] else 0.0
    return row


def bench_skip_rate(device, ways: int = 8, V: int = 1024,
                    E: int = 16384) -> list:
    """The idle-skip mechanism, counted: live vs total (row block × edge
    tile) rounds per shard, scheduled (banded walk) vs unscheduled (dense
    occupancy), on a clustered graph and its uniform adversary."""
    from repro_torch.graph import (clustered_graph, partition_by_src,
                                   uniform_graph)
    from repro_torch.kernels.gas_scatter import ops
    rows = []
    for kind, g in (("clustered", clustered_graph(
                        V, E, n_clusters=V // ops.ROW_BLOCK, p_intra=0.9,
                        seed=3)),
                    ("uniform", uniform_graph(V, E, seed=3))):
        pg = partition_by_src(g, ways)
        live_s = total_s = live_u = total_u = 0
        for p in range(ways):
            dst = torch.from_numpy(pg.dst[p]).to(device)
            mask = torch.from_numpy(pg.mask[p]).to(device)
            ls, ts = ops.schedule_skip_stats(ops.schedule_edges(dst, mask, V))
            lu, tu = ops.dense_skip_stats(dst, mask, V)
            live_s, total_s = live_s + int(ls), total_s + int(ts)
            live_u, total_u = live_u + int(lu), total_u + int(tu)
        for scheduled, live, total in ((True, live_s, total_s),
                                       (False, live_u, total_u)):
            rows.append({
                "mode": "skip_rate", "ways": ways, "V": V, "E": E,
                "graph": kind, "scheduled": scheduled,
                "live_rounds": live, "total_rounds": total,
                "skipped_rounds": total - live,
                "skip_rate": 1.0 - live / total})
    return rows


def bench_partition(device, ways: int = 8, V: int = 1024, E: int = 8192,
                    n_clusters: int = 8, p_intra: float = 0.95) -> list:
    """Islandized partitioning, counted on a scrambled-id clustered graph:
    remote destination rows and dense live rounds, interval vs island."""
    from repro_torch.graph import (COOGraph, clustered_graph,
                                   partition_graph, remote_destination_rows)
    from repro_torch.kernels.gas_scatter import ops
    g0 = clustered_graph(V, E, n_clusters=n_clusters, p_intra=p_intra,
                         seed=3)
    perm = np.random.default_rng(1003).permutation(V).astype(np.int32)
    g = COOGraph(V, perm[g0.src], perm[g0.dst], g0.weights, None)
    rows = []
    for method in ("interval", "island"):
        pg, _ = partition_graph(g, ways, method=method)
        rr = remote_destination_rows(pg)
        live = total = 0
        for p in range(ways):
            lv, tt = ops.dense_skip_stats(
                torch.from_numpy(pg.dst[p]).to(device),
                torch.from_numpy(pg.mask[p]).to(device), V)
            live, total = live + int(lv), total + int(tt)
        rows.append({
            "mode": "partition", "ways": ways, "V": V, "E": E,
            "n_clusters": n_clusters, "p_intra": p_intra, "method": method,
            "remote_rows": int(rr.sum()),
            "remote_rows_max_shard": int(rr.max()),
            "live_rounds": live, "total_rounds": total})
    by = {r["method"]: r for r in rows}
    for r in rows:
        r["remote_rows_vs_interval"] = (
            r["remote_rows"] / max(by["interval"]["remote_rows"], 1))
        r["live_rounds_vs_interval"] = (
            r["live_rounds"] / max(by["interval"]["live_rounds"], 1))
    return rows


def bench_coalesce(mesh, B: int = 8, K1: int = 3, K2: int = 10, F: int = 64,
                   part: int = 32) -> list:
    """Request coalescing, counted: the sage-shaped pair as one
    ``aggregate_multi`` command block vs two ``aggregate_sampled``
    streams — collectives, finds, reduces and bytes per step, and the
    kernel route's forward + backward kernel scatters."""
    from repro_torch.core import cgtrans
    R1 = B * (1 + K1)
    feats = _zeros(mesh, 1, part, F)
    b1 = (_zeros(mesh, 1, R1, 1, dtype=torch.int32), _ones(mesh, 1, R1, 1))
    b2 = (_zeros(mesh, 1, R1, K2, dtype=torch.int32),
          _ones(mesh, 1, R1, K2))

    def sep(f, flow, impl="ref"):
        return (cgtrans.aggregate_sampled(f, *b1, mesh=mesh, dataflow=flow,
                                          impl=impl),
                cgtrans.aggregate_sampled(f, *b2, mesh=mesh, dataflow=flow,
                                          impl=impl))

    def coa(f, flow, impl="ref"):
        return cgtrans.aggregate_multi(f, (b1, b2), mesh=mesh, dataflow=flow,
                                       impl=impl)

    rows = []
    for flow in FLOWS:
        for form, fn in (("separate", sep), ("coalesced", coa)):
            run = count_run(lambda f: fn(f, flow), feats)
            rows.append({
                "mode": "coalesce", "ways": mesh.size, "flow": flow,
                "form": form, "B": B, "K1": K1, "K2": K2, "F": F,
                "all_gather": run.calls.get("all_gather", 0),
                "all_to_all": run.calls.get("all_to_all", 0),
                "finds": run.dispatches["find"],
                "reduces": run.dispatches["reduce"],
                "bytes": float(sum(run.bytes.values()))})
    for form, fn in (("separate", sep), ("coalesced", coa)):
        run = count_run(lambda f: fn(f, "cgtrans", "kernel"), feats,
                       fwd_bwd=True)
        rows.append({
            "mode": "coalesce_grad", "ways": mesh.size, "flow": "cgtrans",
            "form": form, "impl": "pallas",
            "finds": run.dispatches["find"],
            "kernel_scatters": run.dispatches["kernel_scatter"]})
    return rows


def bench_wire(mesh, B_loc: int = 32, part: int = 64) -> list:
    """The compressed wire at the paper's K=50: the same cgtrans dataflow
    under ``wire="f32" / "bf16" / "int8"``, bytes per collective."""
    from repro_torch.core import cgtrans
    rows = []
    for K, F in ((PAPER_K, 128), (PAPER_K, 512)):
        feats = _zeros(mesh, 1, part, F)
        nbrs = _zeros(mesh, 1, B_loc, K, dtype=torch.int32)
        mask = _ones(mesh, 1, B_loc, K)
        for w in ("f32", "bf16", "int8"):
            run = count_run(lambda f, n, m: cgtrans.aggregate_sampled(
                f, n, m, mesh=mesh, dataflow="cgtrans", wire=w),
                feats, nbrs, mask)
            rows.append({
                "mode": "wire", "ways": mesh.size, "K": K, "F": F,
                "B_loc": B_loc, "part": part, "wire": w,
                "bytes": float(sum(run.bytes.values())),
                "all_gather_bytes": float(run.bytes.get("all_gather", 0)),
                "all_to_all_bytes": float(run.bytes.get("all_to_all", 0)),
                "all_gather_count": float(run.calls.get("all_gather", 0)),
                "all_to_all_count": float(run.calls.get("all_to_all", 0))})
    return rows


def bench_sparse(mesh, B_loc: int = 32, part: int = 64, K: int = 10,
                 F: int = 512) -> list:
    """Compressed-sparse features: the baseline raw-row shipment at the
    capacity measured from synthetic tables of density 0.1 / 0.3 / 1.0
    (1.0 fails the ``sparse_fits`` gate and must ship the dense bytes),
    and the SSD → host bytes per gathered row."""
    from repro_torch.core import cgtrans
    from repro_torch.core import sparse as sparsefmt
    ways = mesh.size
    rng = np.random.default_rng(0)
    nbrs = _zeros(mesh, 1, B_loc, K, dtype=torch.int32)
    mask = _ones(mesh, 1, B_loc, K)

    def ship(features, cap):
        return count_run(lambda f, n, m: cgtrans.aggregate_sampled(
            f, n, m, mesh=mesh, dataflow="baseline", features=features,
            sparse_capacity=cap), _zeros(mesh, 1, part, F), nbrs, mask)

    dense = ship("dense", None)
    wpr = sparsefmt.bitmap_words(F)
    rows = []
    for density in (0.1, 0.3, 1.0):
        vals = np.round(rng.standard_normal((ways, part, F)) * 5.0)
        feats = np.where(rng.random(vals.shape) < density,
                         np.where(vals == 0, 1.0, vals), 0.0)
        cap = sparsefmt.table_capacity(feats)
        fits = sparsefmt.sparse_fits(cap, F)
        run = ship("sparse", cap)
        rows.append({
            "mode": "sparse", "ways": ways, "K": K, "F": F, "B_loc": B_loc,
            "part": part, "density": sparsefmt.density_stats(feats)["density"],
            "target_density": density, "capacity": cap, "fits": fits,
            "bytes": float(sum(run.bytes.values())),
            "dense_bytes": float(sum(dense.bytes.values())),
            "all_to_all_bytes": float(run.bytes.get("all_to_all", 0)),
            "dense_all_to_all_bytes": float(dense.bytes.get("all_to_all", 0)),
            "all_gather_count": float(run.calls.get("all_gather", 0)),
            "all_to_all_count": float(run.calls.get("all_to_all", 0)),
            "dense_all_gather_count": float(dense.calls.get("all_gather", 0)),
            "dense_all_to_all_count": float(dense.calls.get("all_to_all", 0)),
            "ssd_bytes_per_row": (cap + wpr) * 4 if fits else F * 4,
            "dense_ssd_bytes_per_row": F * 4})
    return rows


def bench_serving(mesh, V: int = 64, F: int = 16, fanout: int = 10) -> list:
    """Online serving, counted: N single-seed callers drained as ONE fused
    command block vs one block per query — finds per query (the unsharded
    engines' counters), collectives per query (the same blocks on the
    mesh), bit-exactness — and the hot cache's hit rate over four waves
    of one hot seed set."""
    from repro_torch.analysis.budgets import SERVE_CONTRACT_N
    from repro_torch.core import cgtrans
    from repro_torch.graph import uniform_graph
    from repro_torch.serving import ServingEngine

    n = SERVE_CONTRACT_N
    dev = mesh.device
    g = uniform_graph(V, 6 * V, seed=5)
    indptr, indices, _ = g.to_csr()
    rng = np.random.default_rng(7)
    feats = rng.integers(-5, 6, (V, F)).astype(np.float32)
    seeds = [int(s) for s in rng.integers(0, V, n)]

    results, engines = {}, {}
    for form, fuse in (("fused", True), ("naive_per_query", False)):
        eng = ServingEngine(feats, indptr, indices, fanout=fanout,
                            max_batch=n, fuse=fuse, impl="ref", device=dev)
        rids = [eng.submit([s], tenant=j) for j, s in enumerate(seeds)]
        eng.flush()
        results[form] = [eng.result(r) for r in rids]
        engines[form] = eng

    trace = ServingEngine(feats, indptr, indices, fanout=fanout, max_batch=n,
                          mesh=mesh, impl="ref")
    for j, s in enumerate(seeds):
        trace.submit([s], tenant=j)
    fn, fargs = trace.fetch_callable()
    fused = count_run(fn, *fargs)

    def naive(f, blocks_):
        outs = []
        for j in range(n):
            outs.extend(cgtrans.aggregate_multi(
                f, blocks_[2 * j:2 * j + 2], mesh=mesh, dataflow="cgtrans"))
        return tuple(outs)

    naive_run = count_run(naive, *fargs)
    bitexact = all(
        np.array_equal(a.self_rows, b.self_rows)
        and np.array_equal(a.agg_rows, b.agg_rows)
        for a, b in zip(results["fused"], results["naive_per_query"]))
    rows = []
    for form, run in (("fused", fused), ("naive_per_query", naive_run)):
        eng = engines[form]
        ag, a2a = run.calls.get("all_gather", 0), run.calls.get(
            "all_to_all", 0)
        rows.append({
            "mode": "serving", "ways": mesh.size, "form": form, "N": n,
            "V": V, "F": F, "fanout": fanout,
            "command_blocks": eng.stats["command_blocks"],
            "finds": eng.stats["find"],
            "finds_per_query": eng.finds_per_query(),
            "all_gather": ag, "all_to_all": a2a,
            "collectives_per_query": (ag + a2a) / n,
            "bitexact_vs_naive": bool(bitexact)})

    hot = [int(h) for h in rng.choice(V, n, replace=False)]
    ceng = ServingEngine(feats, indptr, indices, fanout=fanout, max_batch=n,
                         cache_capacity=2 * n, impl="ref", device=dev)
    waves = 4
    for _ in range(waves):
        for j, s in enumerate(hot):
            ceng.submit([s], tenant=j)
        ceng.flush()
    snap = ceng.cache.snapshot()
    rows.append({
        "mode": "serving_cache", "ways": 1, "N": n, "waves": waves,
        "V": V, "F": F, "capacity": ceng.cache.capacity,
        "hits": snap["hits"], "misses": snap["misses"],
        "hit_rate": snap["hit_rate"],
        "finds_per_query": ceng.finds_per_query()})
    return rows


def width_rows(mesh) -> list:
    """Every row of this mesh width, in the committed file's order; the
    host-only rows on rank 0 of the 8-way group."""
    rows = [bench_sampled(mesh, K=16, F=128), bench_full_graph(mesh, F=16)]
    if mesh.size != 8:
        return rows
    paper = bench_sampled(mesh, K=PAPER_K, F=128)
    paper["paper_figure"] = f"50x_claim_at_K{PAPER_K}"
    rows.append(paper)
    rows += [bench_sampled(mesh, K=K, F=128) for K in (4, 16, 64)]
    rows += [bench_sampled(mesh, K=16, F=F) for F in (32, 128, 512)]
    if mesh.rank == 0:
        rows += bench_skip_rate(mesh.device)
        rows += bench_partition(mesh.device)
    rows += bench_coalesce(mesh)
    rows += bench_wire(mesh)
    rows += bench_sparse(mesh)
    rows += bench_serving(mesh)
    return rows


def summarize(rows: List[dict]) -> dict:
    """The summary's counted fields (the JAX bench's, without its two
    timing ratios), and the paper claim's check."""
    checked = [r for r in rows if r["mode"] == "sampled" and r["ways"] == 8]
    paper = next(r for r in checked if r.get("paper_figure"))
    failed = [r for r in checked if r["ratio"] <= max(
        r["K"] / 4, PAPER_MIN_RATIO if r.get("paper_figure") else 0.0)]
    by = lambda mode: [r for r in rows if r["mode"] == mode]  # noqa: E731
    sk = [r for r in by("skip_rate") if r["graph"] == "clustered"
          and r["scheduled"]]
    co = {(r["flow"], r["form"]): r for r in by("coalesce")}
    wire = {(r["F"], r["wire"]): r["bytes"] for r in by("wire")}
    serving = by("serving")
    return {
        "claim": "baseline/cgtrans collective bytes > K/4 on the 8-way "
                 f"mesh; >= {PAPER_MIN_RATIO}x at the paper's K={PAPER_K}",
        "checked": len(checked),
        "failed": len(failed),
        "max_ratio": max(r["ratio"] for r in checked),
        "paper_figure_ratio": paper["ratio"],
        "clustered_skipped_rounds": sk[0]["skipped_rounds"],
        "partition_remote_rows": {r["method"]: r["remote_rows"]
                                  for r in by("partition")},
        "partition_dense_live_rounds": {r["method"]: r["live_rounds"]
                                        for r in by("partition")},
        "coalesce_collectives_separate":
            co[("cgtrans", "separate")]["all_gather"]
            + co[("cgtrans", "separate")]["all_to_all"],
        "coalesce_collectives_coalesced":
            co[("cgtrans", "coalesced")]["all_gather"]
            + co[("cgtrans", "coalesced")]["all_to_all"],
        "serving_finds_per_query": {r["form"]: r["finds_per_query"]
                                    for r in serving},
        "serving_collectives_per_query": {
            r["form"]: r["collectives_per_query"] for r in serving},
        "serving_cache_hit_rate": by("serving_cache")[0]["hit_rate"],
        "wire_ratios_K50_F128": {w: wire[(128, "f32")] / wire[(128, w)]
                                 for w in ("bf16", "int8")},
        "sparse_a2a_ratios": {
            str(r["target_density"]):
                r["dense_all_to_all_bytes"] / r["all_to_all_bytes"]
            for r in by("sparse")},
    }


def counted_rows(device: DeviceLike = "cuda",
                 timeout_s: float = TIMEOUT_S) -> dict:
    """``{"rows": [...], "summary": {...}}`` from one ``spawn`` per mesh
    width on ``device`` (gloo ranks sharing one card, or CPU ranks)."""
    from repro_torch.launch.mesh import spawn

    dev = resolve_device(device)
    rows = []
    for ways in WIDTHS:
        ranks = spawn(width_rows, ways, backend="gloo", device=str(dev),
                      timeout_s=timeout_s)
        mesh_rows = [r for r in ranks[0] if r["mode"] not in
                     ("skip_rate", "partition")]
        for rank, got in enumerate(ranks[1:], 1):
            if got != mesh_rows:
                raise RuntimeError(f"{ways}-way rank {rank}'s rows differ "
                                   f"from rank 0's")
        rows += ranks[0]
    order = [row_key(r) for r in committed()["rows"]]
    rows.sort(key=lambda r: order.index(row_key(r))
              if row_key(r) in order else len(order))
    return {"rows": rows, "summary": summarize(rows)}


def committed(path: Optional[os.PathLike] = None) -> dict:
    with open(path or COMMITTED) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "counted_rows.json"))
    ap.add_argument("--committed", default=str(COMMITTED))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    fresh = counted_rows(args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(fresh, indent=2))
    drift, divergent = compare(fresh, committed(args.committed))
    s = fresh["summary"]
    paper = next(r for r in fresh["rows"] if r.get("paper_figure"))
    print(f"wrote {out}: {len(fresh['rows'])} counted rows; paper row "
          f"(K={PAPER_K}, 8 ways): baseline {paper['baseline']:.0f} B, "
          f"cgtrans {paper['cgtrans']:.0f} B, ratio "
          f"{s['paper_figure_ratio']:.2f} (>= {PAPER_MIN_RATIO}); max ratio "
          f"{s['max_ratio']:.2f}")
    reasons = {(fmt_key(k), f): why for (k, f), why in DIVERGENT.items()}
    for where, field, cv, fv in divergent:
        print(f"divergent: {where} {field}: committed {cv}, port {fv} — "
              f"{reasons[(where, field)]}")
    if drift:
        for where, field, cv, fv in drift:
            print(f"DRIFT: {where} {field}: committed {cv}, port {fv}",
                  file=sys.stderr)
        return 1
    print(f"no drift against {args.committed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
