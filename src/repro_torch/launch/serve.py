"""Graph serving launcher: the GraphSAGE serving engine under synthetic
multi-tenant traffic.

Concurrent callers with zipf-skewed seed popularity enqueue into the
size-or-deadline ``RequestQueue``; every drain fuses the pending requests
into ONE ``aggregate_multi`` command block, the hot-vertex cache absorbs
repeat self-row lookups, and the run closes with the engine's health
snapshot. Runs on the card through the FAST-GAS kernels by default::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --requests 48 --tenants 4 --cache 32 --batch 8

``--device cpu`` runs the same path on the CPU (the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Tuple

import numpy as np


def zipf_popularity(n_vertices: int, rng: np.random.Generator) -> np.ndarray:
    """Zipf-skewed seed popularity over a permuted rank order — the hot-set
    concentration the hot-vertex cache exploits."""
    order = rng.permutation(n_vertices)
    p = np.empty(n_vertices)
    p[order] = 1.0 / (np.arange(n_vertices) + 1.0)
    return p / p.sum()


def replay_traffic(eng, *, requests: int, tenants: int,
                   seed: int = 0) -> Tuple[List[int], List[int]]:
    """Submit ``requests`` queries of 1–3 zipf-drawn seeds, round-robin over
    ``tenants``, polling after each submit and flushing at the end.
    Returns (request ids in submit order, requests per tenant)."""
    rng = np.random.default_rng(seed)
    V = eng.n_vertices
    p = zipf_popularity(V, rng)
    rids, per_tenant = [], [0] * tenants
    for i in range(requests):
        n_seeds = int(rng.integers(1, 4))
        seeds = rng.choice(V, n_seeds, p=p)
        tenant = i % tenants
        rids.append(eng.submit(seeds, tenant=tenant))
        per_tenant[tenant] += 1
        eng.poll()                    # dispatches when size/deadline fires
    eng.flush()
    return rids, per_tenant


def _main_graph(args) -> int:
    from repro_torch.graph import uniform_graph
    from repro_torch.serving import ServingEngine

    V = args.vertices
    g = uniform_graph(V, args.degree * V, seed=args.seed,
                      n_features=args.features)
    indptr, indices, _ = g.to_csr()

    eng = ServingEngine(g.features, indptr, indices, fanout=args.fanout,
                        max_batch=args.batch,
                        max_delay_s=args.max_delay_ms / 1e3,
                        cache_capacity=args.cache, sample_seed=args.seed,
                        impl=args.impl, device=args.device)
    print(f"graph serving on {eng.device}: V={V} E={args.degree * V} "
          f"F={args.features} fanout={args.fanout} impl={args.impl} | "
          f"batch={args.batch} deadline={args.max_delay_ms}ms "
          f"cache={args.cache} tenants={args.tenants}")

    t0 = time.perf_counter()
    rids, per_tenant = replay_traffic(eng, requests=args.requests,
                                      tenants=args.tenants, seed=args.seed)
    served = eng.stats["queries"]
    dt = time.perf_counter() - t0

    snap = eng.health_snapshot()
    stats = snap["stats"]
    print(f"served {served}/{args.requests} requests "
          f"({', '.join(f't{t}:{n}' for t, n in enumerate(per_tenant))}) "
          f"in {dt * 1e3:.1f} ms")
    print(f"command blocks: {stats['command_blocks']} "
          f"({stats['queries'] / max(stats['command_blocks'], 1):.1f} "
          f"queries/block) | finds: {stats['find']} "
          f"({snap['finds_per_query']:.3f}/query vs 1.000 naive) | "
          f"kernel scatters: {stats['kernel_scatter']}")
    if "cache" in snap:
        c = snap["cache"]
        print(f"hot cache: {c['hits']}/{c['hits'] + c['misses']} lookups hit "
              f"(rate {c['hit_rate']:.2f}), {c['resident']}/{c['capacity']} "
              f"rows resident, {c['evictions']} evictions")
    mon = snap["monitor"]
    print(f"health: {mon['steps']} dispatches recorded "
          f"({mon['flagged']} flagged), ewma "
          f"{mon['ewma_s'] * 1e3:.1f} ms/dispatch, "
          f"queue depth {snap['queue_depth']}")
    return 0 if served == args.requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8, help="queue max_batch")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--vertices", type=int, default=256)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--cache", type=int, default=32,
                    help="hot-vertex cache capacity (0 disables)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--impl", choices=("kernel", "ref"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return _main_graph(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
