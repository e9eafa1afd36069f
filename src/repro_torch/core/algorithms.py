"""Classic graph algorithms on the GAS engine (paper §3.4, Fig 13).

The paper runs BFS, SSSP, CC and sorting as find-and-compute loops on the
CAM + FAST SRAM pair. Each algorithm here is the same loop over the GAS
primitives (``core/gas.py``: a row gather, then a row-parallel
scatter-reduce), as in the JAX package. ``impl="kernel"`` runs every
scatter on the FAST-GAS dense grid, ``impl="ref"`` on ``scatter_reduce`` /
``index_add_``. The gathers stay a plain index, as the JAX package calls
them without a backend.

The JAX package's ``lax.while_loop`` is a Python loop here that reads its
``changed`` flag once per round (one host sync per round). As the JAX trace
counts the loop body once, ``gas.count_dispatches`` counts the first
round's ``find`` (and, on the kernel route, its ``kernel_scatter``) and
the later rounds run under ``suspend_counting``; every round still
launches its kernel.

All take COO edge tensors and return dense per-vertex results on the
device the edges are on.
"""

from __future__ import annotations

import torch

from repro_torch.core.gas import gas_gather, gas_scatter
from repro_torch.kernels.gas_scatter import ops as gas_ops


def sssp(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
         n_vertices: int, source: int, *, impl: str = "ref",
         max_iters: int = 0) -> torch.Tensor:
    """Bellman-Ford SSSP, the paper's add-then-min GAS atom iterated: each
    round gathers dist[src] (find), adds the edge weight and scatter-mins
    into the dst rows, until no distance falls (or ``max_iters`` rounds,
    default V). Unreached vertices hold +inf."""
    max_iters = max_iters or n_vertices
    dist = torch.full((n_vertices,), float("inf"), dtype=torch.float32,
                      device=src.device)
    dist[source] = 0.0
    w = weights.to(torch.float32)
    it, changed = 0, True
    while changed and it < max_iters:
        with gas_ops.suspend_counting(it > 0):
            relax = gas_gather(dist, src) + w
            best = gas_scatter(dst, relax, n_vertices, op="min", impl=impl)
        new = torch.minimum(dist, best)
        changed = bool((new < dist).any())
        dist, it = new, it + 1
    return dist


def bfs(src: torch.Tensor, dst: torch.Tensor, n_vertices: int, source: int,
        *, impl: str = "ref", max_iters: int = 0) -> torch.Tensor:
    """BFS levels: SSSP with unit weights (the paper deploys BFS so)."""
    return sssp(src, dst, torch.ones(src.shape, dtype=torch.float32,
                                     device=src.device),
                n_vertices, source, impl=impl, max_iters=max_iters)


def connected_components(src: torch.Tensor, dst: torch.Tensor,
                         n_vertices: int, *, impl: str = "ref",
                         max_iters: int = 0) -> torch.Tensor:
    """Min-label propagation over the undirected edges (the paper's CC:
    find-and-update the minimum among matched rows). Returns int32 labels,
    each the minimum vertex id of its component. Labels ride in float32,
    exact below 2^24 vertices, as in the JAX package."""
    max_iters = max_iters or n_vertices
    s = torch.cat([src, dst])
    d = torch.cat([dst, src])
    labels = torch.arange(n_vertices, dtype=torch.float32, device=src.device)
    it, changed = 0, True
    while changed and it < max_iters:
        with gas_ops.suspend_counting(it > 0):
            prop = gas_scatter(d, gas_gather(labels, s), n_vertices,
                               op="min", impl=impl)
        new = torch.minimum(labels, prop)
        changed = bool((new < labels).any())
        labels, it = new, it + 1
    return labels.to(torch.int32)


def gas_sort(x: torch.Tensor, *, impl: str = "ref") -> torch.Tensor:
    """The paper's fully-concurrent insert sort: every pivot compared
    against all rows at once gives its stable rank,
        rank_i = Σ_j [x_j < x_i] + Σ_j [x_j == x_i ∧ j < i],
    then one GAS scatter places every value at its rank row."""
    n = x.shape[0]
    lt = (x[None, :] < x[:, None]).sum(1)
    idx = torch.arange(n, device=x.device)
    eq = ((x[None, :] == x[:, None]) & (idx[None, :] < idx[:, None])).sum(1)
    rank = (lt + eq).to(torch.int32)
    return gas_scatter(rank, x, n, op="add", impl=impl)


def feature_embedding(src: torch.Tensor, dst: torch.Tensor,
                      weights: torch.Tensor, feats: torch.Tensor, *,
                      op: str = "add", impl: str = "ref") -> torch.Tensor:
    """Paper Fig 12: aggregation over a COO graph,
    out[v] = reduce_{(u, v, w)} w·feats[u] — the GCN aggregation atom."""
    vals = gas_gather(feats, src)
    if op == "add":
        vals = vals * weights[:, None].to(vals.dtype)
    return gas_scatter(dst, vals, feats.shape[0], op=op, impl=impl)
