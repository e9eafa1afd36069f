#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each failing hard (exit status 1, no result line):

1. build the FAST-GAS kernels from ``src/repro_torch/kernels/gas_scatter/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes phases 3 and 4 launch (op add with unit and with integer
   weights, with and without all-zero feature blocks; max and min, also
   with NaN values; integer data bit-exact, NaN cells where the plain
   version has them, normal data within rtol = atol = 1e-5), and time the
   kernel, the plain version, one library call computing the same function
   (``torch.sparse.mm`` / ``scatter_reduce``, never used by the port) and
   the memory-bound floor;
3. serving: the GraphSAGE serving engine over a uniform graph of 2^20
   vertices, 16 edges per vertex and Reddit's 602 features, 64 zipf-skewed
   requests of 1–3 seeds from 4 tenants, fan-out 50, ``max_batch=8``, a
   32-row hot cache, once with the banded walk (``scheduled=True``) and once
   on the dense grid (``scheduled=False``); every request is served and
   matches the ``impl="ref"`` engine;
4. inference: ``sage_forward`` at Reddit width (``PALLAS_CONFIG``: F=602,
   H=256, C=41, K1=K2=50, B=64, 16-row command queue, banded walk) on a
   ``GraphBatchStream`` batch; the logits are finite and match
   ``impl="ref"`` within rtol = atol = 1e-4 (the f32 sums run in another
   order through two layers).

Each kernel's launch count is set to 0 just before each path of phases 3
and 4 and read just after; a kernel that a path should launch and did not
fails the run. The last lines are the kernels' JSON, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/gas_scatter/csrc/gas_scatter.cu"
REPLACES = {
    "gas_scatter_banded": "src/repro/kernels/gas_scatter/kernel.py:211",
    "gas_scatter_dense": "src/repro/kernels/gas_scatter/kernel.py:266",
}
# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

V, DEGREE, F = 1 << 20, 16, 602
FANOUT, REQUESTS, TENANTS, MAX_BATCH, CACHE = 50, 64, 4, 8, 32
BATCH = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def fake_clock(step=1e-4):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def event_ms(torch, fn, iters, warm=3):
    """Mean ms per call between CUDA events around ``iters`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, kernel_symbol, iters=50):
    """Mean device time of the kernel named ``kernel_symbol`` per call, from
    the profiler's trace; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_symbol in evt.key:
            total += getattr(evt, "device_time_total", 0.0) or 0.0
            count += evt.count
    if count == 0 or total == 0.0:
        return None
    return total / 1e3 / count


def profile_call(torch, fn, top=8):
    """Profile one call: (profiled wall ms, device kernel ms, top host ops
    as (name, count, self CPU ms)). The wall includes the profiler's own
    overhead, so the busy share derived from it is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device = sum(e.device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA) / 1e3
    hosts = sorted(avgs, key=lambda e: e.self_cpu_time_total,
                   reverse=True)[:top]
    return wall, device, [(e.key, e.count, e.self_cpu_time_total / 1e3)
                          for e in hosts]


def bound(call):
    """(bound_ms, bound_by) of a kernel call: the bytes this call's data
    needs (ids and weights of every visited tile, the value rows of its
    live edges in its live feature blocks, the work list or occupancy map,
    the output once) over HBM bandwidth, against its f32 operations over
    the f32 peak; the larger wins."""
    import torch

    if call.kernel == "gas_scatter_banded":
        work, dst, vals, R = call.args
        rows = work[work[:, 2] == 1]
        rb, tiles = rows[:, 0].long(), rows[:, 1].long()
        if work.shape[1] > 4:
            fl = rows[:, 4:]
        else:
            fl = torch.ones((rows.shape[0], vals.shape[1] // 32),
                            dtype=torch.int32, device=vals.device)
        meta = work.numel() * 4
    else:
        dst, vals, occ, R = call.args
        pairs = torch.nonzero(occ > 0)
        rb, tiles = pairs[:, 0], pairs[:, 1]
        fl = torch.ones((pairs.shape[0], vals.shape[1] // 32),
                        dtype=torch.int32, device=vals.device)
        meta = occ.numel() * 4
    E, Fp = vals.shape
    blocks = torch.div(dst.reshape(-1, 128)[tiles], 128, rounding_mode="floor")
    live_edges = (blocks == rb[:, None]).sum(1)     # edges each round reads
    feat_live = fl.sum(1) * 32
    n_tiles = int(tiles.unique().numel())
    id_bytes = n_tiles * 128 * (4 + (4 if call.kwargs.get("weights")
                                     is not None else 0))
    value_bytes = int((live_edges * feat_live).sum()) * 4
    out_bytes = R * Fp * 4
    nbytes = meta + id_bytes + value_bytes + out_bytes
    ops = int((live_edges * feat_live).sum()) * (
        2 if call.kwargs.get("op") == "add" else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_fn(torch, call):
    """One PyTorch call computing the same function on the same inputs: a
    sparse (R × E) weight matrix times the values for add, a
    ``scatter_reduce_`` for max/min. Built once; only the call is timed."""
    dst, vals = ((call.args[1], call.args[2])
                 if call.kernel == "gas_scatter_banded"
                 else (call.args[0], call.args[1]))
    R = call.args[3]
    op, w = call.kwargs["op"], call.kwargs.get("weights")
    if op == "add":
        ok = dst < R
        e = torch.nonzero(ok)[:, 0]
        wv = (w[e] if w is not None
              else torch.ones(e.numel(), device=vals.device))
        A = torch.sparse_coo_tensor(torch.stack([dst[e].long(), e]), wv,
                                    (R, dst.numel()), check_invariants=True
                                    ).coalesce().to_sparse_csr()
        return lambda: torch.sparse.mm(A, vals)
    idx = dst.long()[:, None].expand(-1, vals.shape[1]).contiguous()
    fill = float("-inf") if op == "max" else float("inf")
    out = torch.full((R + 1, vals.shape[1]), fill, device=vals.device)
    red = "amax" if op == "max" else "amin"
    return lambda: out.scatter_reduce_(0, idx, vals, red, include_self=True)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def segment_calls(torch, ops, table, nbrs, mask, op, schedule, data,
                  zero_blocks, weights="unit"):
    """The kernel call the main path makes for one fan-out segment: the
    (R, K) ids gathered from the table, seed destinations
    ``repeat(arange(R), K)``, unit weights for add. ``data``: "normal"
    (the table's rows), "int" (rounded to integers) or "nan" (integers with
    a NaN in every 97th edge's every 13th feature); ``weights="int"`` swaps
    the unit weights for integers in [-3, 3] made from a seed."""
    import numpy as np

    R, K = nbrs.shape
    own = mask & (nbrs >= 0) & (nbrs < table.shape[0])
    rows = table[nbrs.clamp(0, table.shape[0] - 1).reshape(-1).long()]
    if data in ("int", "nan"):
        rows = torch.round(rows * 4)
    if data == "nan":
        rows[::97, ::13] = float("nan")
    if zero_blocks:
        rows = rows.clone()
        rows[:, 64:192] = 0.0
    seed = torch.arange(R, dtype=torch.int32,
                        device=table.device).repeat_interleave(K)
    sched = (ops.schedule_edges(seed, own.reshape(-1), R, assume_sorted=True)
             if schedule else None)
    w = None
    if op == "add":
        w = (torch.ones(R * K, device=table.device) if weights == "unit"
             else torch.from_numpy(np.random.default_rng(2).integers(
                 -3, 4, R * K).astype(np.float32)).to(table.device))
    return ops.fused_call(seed, rows.contiguous(), w, own.reshape(-1), R,
                          op=op, schedule=sched)


# (op, data, feature skip, weights) of every phase-2 comparison
CASES = ([("add", data, zb, "unit") for data in ("int", "normal")
          for zb in (False, True)]
         + [("add", data, zb, "int") for data in ("int", "normal")
            for zb in (False, True)]
         + [(op, data, False, None) for op in ("max", "min")
            for data in ("int", "normal", "nan")])


def phase_kernels(torch, ops, K, table, shapes):
    """shapes: {kernel: (nbrs, mask)} from the main path. Returns the JSON
    entries' measured fields per kernel."""
    out = {}
    for name, (nbrs, mask) in shapes.items():
        scheduled = name == "gas_scatter_banded"
        max_err = 0.0
        for op, data, zero_blocks, weights in CASES:
            call = segment_calls(torch, ops, table, nbrs, mask, op,
                                 scheduled, data, zero_blocks, weights)
            check(call.kernel == name, f"{call.kernel} != {name}")
            got = call.run()
            want = call.run_plain()
            torch.cuda.synchronize()
            label = (f"{name} op={op} data={data} feature_skip={zero_blocks}"
                     f" weights={weights}")
            check(torch.equal(torch.isinf(got), torch.isinf(want)),
                  f"{label}: identity rows differ")
            check(torch.equal(torch.isnan(got), torch.isnan(want)),
                  f"{label}: NaN cells differ")
            check(data != "nan" or bool(torch.isnan(want).any()),
                  f"{label}: no NaN reached the output")
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) \
                if fin.any() else 0.0
            if data in ("int", "nan"):
                num = ~torch.isnan(want)
                check(torch.equal(got[num], want[num]),
                      f"{label}: not bit-exact (err {err})")
            else:
                check(torch.allclose(got[fin], want[fin], rtol=1e-5,
                                     atol=1e-5), f"{label}: err {err}")
                max_err = max(max_err, err)
            log(f"  {label}: max_abs_err={err:.3g} ok")
        # timings at the main path's op: add with unit weights, normal data
        call = segment_calls(torch, ops, table, nbrs, mask, "add", scheduled,
                             "normal", False)
        symbol = "banded_kernel" if scheduled else "dense_kernel"
        entry = {
            "max_abs_err": max_err,
            "ms": event_ms(torch, call.run, 200),
            "device_ms": device_ms(torch, call.run, symbol),
            "plain_ms": event_ms(torch, call.run_plain, 10),
            "library_ms": event_ms(torch, library_fn(torch, call), 200),
        }
        entry["bound_ms"], entry["bound_by"] = bound(call)
        for op in ("max", "min"):
            c = segment_calls(torch, ops, table, nbrs, mask, op, scheduled,
                              "normal", False)
            log(f"  {name} op={op}: kernel {event_ms(torch, c.run, 200):.4f}"
                f" ms, library {event_ms(torch, library_fn(torch, c), 200):.4f}"
                f" ms, bound {bound(c)[0]:.6f} ms")
        work_shape = tuple(call.args[0].shape) if scheduled else None
        log(f"  {name} add+w at values {tuple(call.args[2 if scheduled else 1].shape)}"
            f" rows {call.args[3]} work {work_shape}: {json.dumps(entry)}")
        K.reset_launch_counts()
        out[name] = entry
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def serve(ServingEngine, replay_traffic, feats, indptr, indices, **kw):
    eng = ServingEngine(feats, indptr, indices, fanout=FANOUT,
                        max_batch=MAX_BATCH, cache_capacity=CACHE,
                        clock=fake_clock(), sample_seed=0, device="cuda",
                        **kw)
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, per_tenant = replay_traffic(eng, requests=REQUESTS,
                                      tenants=TENANTS, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results = {r: eng.result(r) for r in rids}
    check(eng.stats["queries"] == REQUESTS and len(results) == REQUESTS,
          f"served {eng.stats['queries']}/{REQUESTS}")
    snap = eng.health_snapshot()
    log(f"  impl={eng.impl} scheduled={kw.get('scheduled')}: served "
        f"{eng.stats['queries']}/{REQUESTS} in {dt * 1e3:.1f} ms over "
        f"{eng.stats['command_blocks']} command blocks, tenants {per_tenant},"
        f" stats {eng.stats}, cache hit rate "
        f"{snap['cache']['hit_rate']:.3f}")
    del eng
    torch.cuda.empty_cache()
    return results


def compare_serving(ref, got, label):
    err = 0.0
    for rid, a in ref.items():
        b = got[rid]
        check(a.tenant == b.tenant, f"{label}: tenant of {rid}")
        check((a.self_rows == b.self_rows).all(), f"{label}: self rows {rid}")
        check((a.from_cache == b.from_cache).all(), f"{label}: cache {rid}")
        check(b.agg_rows.shape == a.agg_rows.shape, f"{label}: shape {rid}")
        d = float(abs(a.agg_rows - b.agg_rows).max())
        check(d <= 1e-5 + 1e-5 * float(abs(a.agg_rows).max()),
              f"{label}: agg rows of {rid} off by {d}")
        err = max(err, d)
    log(f"  {label}: all {len(ref)} results match impl=ref "
        f"(max |agg diff| {err:.3g})")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
    from repro_torch.core.gcn import (feature_table, gcn_schema, sage_forward,
                                      sage_loss)
    from repro_torch.common.schema import init_params
    from repro_torch.data import GraphBatchStream, synthetic_node_labels
    from repro_torch.graph import uniform_graph
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.kernels.gas_scatter import ops
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.serving import ServingEngine

    smi = smi_line()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: build")
    t0 = time.perf_counter()
    lib = K.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    g = uniform_graph(V, DEGREE * V, seed=0, n_features=F)
    indptr, indices, _ = g.to_csr()
    labels = synthetic_node_labels(g.features, CONFIG.n_classes, seed=0)
    stream = GraphBatchStream(g, labels, 1, BATCH, k1=FANOUT, k2=FANOUT,
                              seed=0)
    batch = stream.batch_at(0)
    log(f"  graph V={V} E={DEGREE * V} F={F} and batch made in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels against their plain versions")
    table = feature_table(g.features, device=dev).reshape(V, F)
    chunk = PALLAS_CONFIG.request_chunk
    req_rng = np.random.default_rng(1)
    serve_seeds = req_rng.integers(0, V, 3)
    from repro_torch.graph import host_sample_csr
    s_nbrs, s_mask = host_sample_csr(indptr, indices, serve_seeds, FANOUT,
                                     seed=0)
    shapes = {
        # inference: one 16-row command-queue chunk of the 2-hop segment
        "gas_scatter_banded": (
            torch.from_numpy(batch["nbrs2"][0, :chunk]).to(dev),
            torch.from_numpy(batch["mask2"][0, :chunk].copy()).to(dev)),
        # serving, scheduled=False: one 3-seed request's fan-out segment
        "gas_scatter_dense": (torch.from_numpy(s_nbrs).to(dev),
                              torch.from_numpy(s_mask).to(dev)),
    }
    measured = phase_kernels(torch, ops, K, table, shapes)
    del table
    torch.cuda.empty_cache()

    log("phase 3: serving")
    launches = {name: 0 for name in REPLACES}
    ref = serve(ServingEngine, replay_traffic, g.features, indptr, indices,
                impl="ref")
    for scheduled, kernel in ((True, "gas_scatter_banded"),
                              (False, "gas_scatter_dense")):
        K.reset_launch_counts()
        got = serve(ServingEngine, replay_traffic, g.features, indptr,
                    indices, impl="kernel", scheduled=scheduled)
        counts = K.launch_counts()
        log(f"  launches with scheduled={scheduled}: {counts}")
        check(counts[kernel] > 0, f"serving never launched {kernel}")
        for name in launches:
            launches[name] += counts[name]
        compare_serving(ref, got, f"scheduled={scheduled}")

    log("phase 4: inference")
    feats = feature_table(g.features, device=dev)
    params = init_params(gcn_schema(PALLAS_CONFIG), 0, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits = sage_forward(params, feats, batch, PALLAS_CONFIG)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"  launches: {counts}")
    check(counts["gas_scatter_banded"] > 0,
          "inference never launched gas_scatter_banded")
    for name in launches:
        launches[name] += counts[name]
    want = sage_forward(params, feats, batch, CONFIG)
    # warm timings, after the counted run: one more call of each
    timed = {}
    for label, cfg in (("kernel", PALLAS_CONFIG), ("ref", CONFIG)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sage_forward(params, feats, batch, cfg)
        torch.cuda.synchronize()
        timed[label] = time.perf_counter() - t0
    check(tuple(logits.shape) == (1, BATCH, CONFIG.n_classes),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    err = float((logits - want).abs().max())
    check(torch.allclose(logits, want, rtol=1e-4, atol=1e-4),
          f"logits off the ref by {err}")
    loss, metrics = sage_loss(params, feats, batch, PALLAS_CONFIG)
    check(bool(torch.isfinite(loss)), "non-finite loss")
    wall, device, hosts = profile_call(
        torch, lambda: sage_forward(params, feats, batch, PALLAS_CONFIG))
    log(f"  profile of one warm kernel sage_forward (profiler on): wall "
        f"{wall:.1f} ms, device time {device:.2f} ms "
        f"({100 * device / wall:.1f}% busy); top host ops (self CPU ms): "
        + "; ".join(f"{k} x{n} {ms:.1f}" for k, n, ms in hosts))
    log(f"  logits {tuple(logits.shape)} finite, max |kernel - ref| "
        f"{err:.3g}; loss {float(loss):.4f}; sage_forward {t_kernel * 1e3:.1f}"
        f" ms (kernel, first call); warm {timed['kernel'] * 1e3:.1f} ms "
        f"(kernel, {PALLAS_CONFIG.request_chunk}-row chunks) vs "
        f"{timed['ref'] * 1e3:.1f} ms (ref, unchunked)")

    kernels = []
    for name, entry in measured.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "device_ms": entry["device_ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
