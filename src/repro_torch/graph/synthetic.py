"""Synthetic graph generators (numpy; identical draws to the JAX package).

* ``rmat`` — Graph500-style Kronecker/R-MAT (A=0.57,B=0.19,C=0.19), the
  generator behind the paper's Fig 16(b) "G500 dataset at different scales".
* ``clustered_graph`` — community-structured graphs, the favourable case of
  the idle-skip schedule.
* ``uniform_graph`` — uniform random edges, its adversary.
* ``table2_like`` — graphs with the vertex/edge/feature ratios of the
  paper's Table II datasets, scaled down; the full-size ``TABLE_II``
  parameters feed the analytic cost model (``core/cost_model.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.graph.structure import COOGraph

# Paper Table II (full-size): name -> (nodes, edges, n_features)
TABLE_II: Dict[str, tuple] = {
    "Reddit": (37.3e6, 53.9e9, 602),
    "Movielens": (22.2e6, 59.2e9, 1000),
    "Amazon": (265.9e6, 9.5e9, 32),
    "OGBN-100M": (179.1e6, 5.0e9, 32),
    "Protein-PI": (9.1e6, 8.8e9, 512),
}


def rmat(scale: int, edge_factor: int = 16, *, a=0.57, b=0.19, c=0.19,
         seed: int = 0, weights: bool = False) -> COOGraph:
    """R-MAT graph with 2^scale vertices and edge_factor·2^scale edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < ab)          # B quadrant: dst high bit
        go_down = (r >= ab) & (r < abc)         # C quadrant: src high bit
        go_diag = r >= abc                      # D quadrant: both
        src |= ((go_down | go_diag).astype(np.int64)) << bit
        dst |= ((go_right | go_diag).astype(np.int64)) << bit
    w = rng.random(m).astype(np.float32) + 0.05 if weights else None
    return COOGraph(n, src.astype(np.int32), dst.astype(np.int32), w)


def _cluster_bounds(n_vertices: int, n_clusters: int):
    """(starts, sizes) of contiguous clusters covering every vertex; sizes
    differ by at most one and no cluster is empty."""
    C = max(min(n_clusters, n_vertices), 1)
    base, extra = divmod(n_vertices, C)
    sizes = np.full(C, base, np.int64)
    sizes[:extra] += 1
    starts = np.zeros(C, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    return starts, sizes


def clustered_graph(n_vertices: int, n_edges: int, *, n_clusters: int = 8,
                    p_intra: float = 0.9, seed: int = 0, n_features: int = 0,
                    weights: bool = False) -> COOGraph:
    """Community-structured graph: ``p_intra`` of the edges stay inside a
    contiguous vertex cluster (planted-partition style)."""
    rng = np.random.default_rng(seed)
    starts, sizes = _cluster_bounds(n_vertices, n_clusters)
    C = len(sizes)
    c_src = rng.integers(0, C, n_edges)
    c_dst = np.where(rng.random(n_edges) < p_intra,
                     c_src, rng.integers(0, C, n_edges))
    src = (starts[c_src]
           + (rng.random(n_edges) * sizes[c_src]).astype(np.int64)).astype(np.int32)
    dst = (starts[c_dst]
           + (rng.random(n_edges) * sizes[c_dst]).astype(np.int64)).astype(np.int32)
    w = rng.random(n_edges).astype(np.float32) + 0.05 if weights else None
    feats = (rng.standard_normal((n_vertices, n_features)).astype(np.float32)
             if n_features else None)
    return COOGraph(n_vertices, src, dst, w, feats)


def uniform_graph(n_vertices: int, n_edges: int, *, seed: int = 0,
                  n_features: int = 0, weights: bool = False) -> COOGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_vertices, n_edges, dtype=np.int32)
    w = rng.random(n_edges).astype(np.float32) + 0.05 if weights else None
    feats = (rng.standard_normal((n_vertices, n_features)).astype(np.float32)
             if n_features else None)
    return COOGraph(n_vertices, src, dst, w, feats)


def table2_like(name: str, *, scale_down: float = 1e4, seed: int = 0,
                max_features: int = 64) -> COOGraph:
    """A small graph preserving a Table II dataset's shape ratios."""
    nodes, edges, feats = TABLE_II[name]
    n = max(int(nodes / scale_down), 64)
    m = max(int(edges / scale_down), 4 * n)
    f = min(int(feats), max_features)
    g = rmat(int(np.ceil(np.log2(n))), max(m // (1 << int(np.ceil(np.log2(n)))), 1),
             seed=seed)
    rng = np.random.default_rng(seed + 1)
    g.features = rng.standard_normal((g.n_vertices, f)).astype(np.float32)
    return g
