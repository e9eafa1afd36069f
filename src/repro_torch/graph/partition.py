"""Vertex-interval graph partitioning (paper §4.3, "vertex-orientated").

Vertices are split into P contiguous intervals; each partition *owns* the
features of its interval and every edge whose **source** lies in it, so the
gather side of gather-and-scatter is always local to its shard and only
aggregated destination features cross the interconnect (CGTrans).

Edges per partition are padded to the max count so the per-shard arrays are
regular ``(P, E_max)``. A numpy copy of the JAX package's module of the same
name: both packages cut the same graph at the same boundaries.

**Islandized locality.** ``islandize`` computes, once per graph on the
host, a vertex relabeling that packs BFS-grown, boundary-refined islands
of connected vertices into contiguous id intervals aligned with the cut
``partition_by_src`` makes. On the relabeled graph each shard then owns a
community (fewer remote all_to_all destination rows) and the
destination-binned edge schedule has a near block-diagonal occupancy.
The relabeling is a pure permutation: consumers translate ids through
``IslandPartition.relabel`` on the way in and un-permute outputs through
it on the way out, so islandized ≡ interval bit for bit. The
port's ``islandize`` is the reference's line for line (same seeds, BFS,
label propagation and packing, same dtypes), so both packages relabel a
graph identically.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graph.structure import COOGraph


@dataclasses.dataclass
class PartitionedGraph:
    n_vertices: int
    n_parts: int
    part_size: int               # vertices per interval (padded)
    src: np.ndarray              # (P, E_max) int32, LOCAL src ids (src - lo)
    dst: np.ndarray              # (P, E_max) int32, GLOBAL dst ids
    weights: np.ndarray          # (P, E_max) float32
    mask: np.ndarray             # (P, E_max) bool — padding mask
    features: Optional[np.ndarray] = None  # (P, part_size, F) owner shards

    @property
    def e_max(self) -> int:
        return int(self.src.shape[1])


def interval_size(n_vertices: int, n_parts: int, *, pad_multiple: int = 8) -> int:
    """Vertices per interval: ceil(V/P) rounded up to ``pad_multiple``. The
    single source of truth for the interval cut."""
    part = -(-n_vertices // n_parts)             # ceil
    part = -(-part // pad_multiple) * pad_multiple
    return max(part, 1)


def partition_by_src(g: COOGraph, n_parts: int, *, pad_multiple: int = 8) -> PartitionedGraph:
    V = g.n_vertices
    part = interval_size(V, n_parts, pad_multiple=pad_multiple)
    owner = g.src // part
    order = np.argsort(owner, kind="stable")
    src, dst = g.src[order], g.dst[order]
    w = g.weights[order] if g.weights is not None else np.ones_like(src, np.float32)
    counts = np.bincount(owner, minlength=n_parts)
    e_max = max(int(counts.max()), 1) if counts.size else 1
    e_max = -(-e_max // pad_multiple) * pad_multiple

    ps = np.zeros((n_parts, e_max), np.int32)
    pd = np.zeros((n_parts, e_max), np.int32)
    pw = np.zeros((n_parts, e_max), np.float32)
    pm = np.zeros((n_parts, e_max), bool)
    # one scatter by (owner, rank-within-owner): the sorted edge stream is
    # grouped by owner, so rank = position minus the owner's start offset
    starts = np.zeros(n_parts + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    owner_sorted = owner[order]
    rank = np.arange(src.size, dtype=np.int64) - starts[owner_sorted]
    ps[owner_sorted, rank] = src - owner_sorted * part  # local ids
    pd[owner_sorted, rank] = dst
    pw[owner_sorted, rank] = w
    pm[owner_sorted, rank] = True

    feats = None
    if g.features is not None:
        F = g.features.shape[1]
        # intervals are contiguous in id order: one flat copy, then reshape
        # (n_parts·part ≥ V always, so the tail rows are the zero padding)
        flat = np.zeros((n_parts * part, F), g.features.dtype)
        flat[:V] = g.features
        feats = flat.reshape(n_parts, part, F)

    return PartitionedGraph(V, n_parts, part, ps, pd, pw, pm, feats)


# ---------------------------------------------------------------------------
# islandized locality partitioning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IslandPartition:
    """A vertex relabeling packing locality islands into shard intervals.

    ``relabel[old_id] = new_id`` and ``inverse[new_id] = old_id`` are mutual
    inverses over ``[0, V)``; every interval boundary ``p · part_size`` is
    also an island-packing boundary.
    """

    n_vertices: int
    n_parts: int
    part_size: int
    relabel: np.ndarray          # (V,) int32: old id → new id
    inverse: np.ndarray          # (V,) int32: new id → old id
    island_of: np.ndarray        # (V,) int32: island of each OLD id
    n_islands: int

    def relabel_rows(self, rows: np.ndarray) -> np.ndarray:
        """Per-old-vertex rows in new id order: ``out[new] = rows[old]``."""
        return rows[self.inverse]

    def unrelabel_rows(self, rows: np.ndarray) -> np.ndarray:
        """Per-new-vertex rows back in original id order:
        ``out[old] = rows[new]``."""
        return rows[self.relabel]


def _undirected_csr(g: COOGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrized adjacency of ``g`` as (indptr, indices) over old ids."""
    V = g.n_vertices
    es = np.concatenate([g.src, g.dst]).astype(np.int64)
    ed = np.concatenate([g.dst, g.src]).astype(np.int64)
    deg = np.bincount(es, minlength=V)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    order = np.argsort(es, kind="stable")
    return indptr, ed[order]


def islandize(g: COOGraph, n_parts: int, *, pad_multiple: int = 8,
              refine_passes: int = 2) -> IslandPartition:
    """Greedy BFS island growing + label-propagation boundary refinement,
    on the host, O(V + E), once per graph.

    1. **Grow**: BFS from high-degree seeds over the symmetrized
       adjacency, capping each island at ``part_size`` vertices; BFS
       discovery order becomes the intra-island id order.
    2. **Refine**: label-propagation passes move a boundary vertex to the
       neighboring island holding most of its edges, under the same cap.
    3. **Pack**: islands fill P bins of ``part_size`` best-fit-decreasing;
       when no island fits a bin's residual space the largest is split at
       the boundary (in BFS-rank order), so every bin before the last
       non-empty one is exactly full — the alignment with
       ``partition_by_src``'s cut.
    """
    V = g.n_vertices
    part = interval_size(V, n_parts, pad_multiple=pad_multiple)
    indptr, adj = _undirected_csr(g)
    deg = np.diff(indptr)

    island = np.full(V, -1, np.int32)
    bfs_rank = np.zeros(V, np.int64)
    n_islands = 0
    t = 0
    # hubs seed first: the densest neighborhoods anchor their own islands
    for s in np.argsort(-deg, kind="stable"):
        if island[s] >= 0:
            continue
        iid = n_islands
        n_islands += 1
        island[s] = iid
        q = deque([s])
        size = 1                                 # assigned = |popped| + |queued|
        while q:
            v = q.popleft()
            bfs_rank[v] = t
            t += 1
            if size >= part:
                continue                         # drain only — island is full
            for u in adj[indptr[v]:indptr[v + 1]]:
                if island[u] < 0 and size < part:
                    island[u] = iid
                    q.append(u)
                    size += 1

    # label-propagation refinement (capacity-capped KL-style moves)
    sizes = np.bincount(island, minlength=n_islands).astype(np.int64)
    for _ in range(max(refine_passes, 0)):
        moved = 0
        for v in range(V):
            nbr = adj[indptr[v]:indptr[v + 1]]
            if nbr.size == 0:
                continue
            cur = int(island[v])
            cnt = np.bincount(island[nbr], minlength=n_islands)
            best = int(np.argmax(cnt))
            if (best != cur and cnt[best] > cnt[cur]
                    and sizes[best] < part and sizes[cur] > 1):
                island[v] = best
                sizes[best] += 1
                sizes[cur] -= 1
                moved += 1
        if not moved:
            break

    # rebuild member lists: grouped by island, BFS-discovery order within
    grouped = np.lexsort((bfs_rank, island))
    sizes = np.bincount(island, minlength=n_islands).astype(np.int64)
    pool: List[np.ndarray] = [m for m in np.split(grouped, np.cumsum(sizes)[:-1])
                              if m.size]
    pool.sort(key=lambda m: -m.size)             # best-fit-decreasing

    new_order: List[np.ndarray] = []
    for _ in range(n_parts):
        cap_left = part
        while cap_left > 0 and pool:
            pick = next((i for i, m in enumerate(pool) if m.size <= cap_left), None)
            if pick is None:
                # nothing fits: split the largest island at the bin boundary
                # (its BFS-rank prefix stays; the rest re-enters the pool),
                # filling the bin exactly
                m = pool.pop(0)
                new_order.append(m[:cap_left])
                rest = m[cap_left:]
                j = next((i for i, mm in enumerate(pool) if mm.size <= rest.size),
                         len(pool))
                pool.insert(j, rest)
                cap_left = 0
            else:
                m = pool.pop(pick)
                new_order.append(m)
                cap_left -= m.size
        if not pool:
            break

    inverse = (np.concatenate(new_order).astype(np.int32) if new_order
               else np.zeros(0, np.int32))
    relabel = np.empty(V, np.int32)
    relabel[inverse] = np.arange(V, dtype=np.int32)
    return IslandPartition(V, n_parts, part, relabel, inverse, island, n_islands)


def relabel_graph(g: COOGraph, isl: IslandPartition) -> COOGraph:
    """``g`` with every vertex id renamed through ``isl.relabel``: edge
    order and weights unchanged, the feature table reordered so row
    ``new_id`` holds the old vertex's features."""
    r = isl.relabel
    feats = None
    if g.features is not None:
        feats = np.ascontiguousarray(isl.relabel_rows(g.features))
    return COOGraph(g.n_vertices, r[g.src].astype(np.int32),
                    r[g.dst].astype(np.int32), g.weights, feats)


def partition_graph(g: COOGraph, n_parts: int, *, method: str = "interval",
                    pad_multiple: int = 8, refine_passes: int = 2,
                    ) -> Tuple[PartitionedGraph, Optional[IslandPartition]]:
    """Partition ``g`` for the sharded dataflows.

    ``method="interval"`` is the plain contiguous-id split (island map
    None); ``method="island"`` islandizes first and partitions the
    relabeled graph, so the ``PartitionedGraph`` lives in the new id space
    and the returned ``IslandPartition`` translates ids in and outputs
    back (``GCNConfig.partition="island"``).
    """
    if method == "interval":
        return partition_by_src(g, n_parts, pad_multiple=pad_multiple), None
    if method == "island":
        isl = islandize(g, n_parts, pad_multiple=pad_multiple,
                        refine_passes=refine_passes)
        return partition_by_src(relabel_graph(g, isl), n_parts,
                                pad_multiple=pad_multiple), isl
    raise ValueError(f"unknown partition method {method!r} "
                     "(expected 'interval' or 'island')")


def remote_destination_rows(pg: PartitionedGraph) -> np.ndarray:
    """Per-shard count of DISTINCT live destination rows owned elsewhere:
    under CGTrans each such row is one aggregated partial the shard ships
    through the all_to_all."""
    out = np.zeros(pg.n_parts, np.int64)
    for p in range(pg.n_parts):
        d = pg.dst[p][pg.mask[p]]
        out[p] = np.unique(d[d // pg.part_size != p]).size
    return out
