"""Vertex-interval graph partitioning (paper §4.3, "vertex-orientated").

Vertices are split into P contiguous intervals; each partition *owns* the
features of its interval and every edge whose **source** lies in it, so the
gather side of gather-and-scatter is always local to its shard and only
aggregated destination features cross the interconnect (CGTrans).

Edges per partition are padded to the max count so the per-shard arrays are
regular ``(P, E_max)``. A numpy copy of the JAX package's module of the same
name: both packages cut the same graph at the same boundaries.
``partition_graph(method="island")`` (the islandized relabeling) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


def partition_graph(g: COOGraph, n_parts: int, *, method: str = "interval",
                    pad_multiple: int = 8, refine_passes: int = 2,
                    ) -> Tuple[PartitionedGraph, None]:
    """Partition ``g`` for the sharded dataflows: ``method="interval"`` is
    the plain contiguous-id split (the second element, the island map, is
    None). ``method="island"`` raises until islandization is ported."""
    if method == "interval":
        return partition_by_src(g, n_parts, pad_multiple=pad_multiple), None
    if method == "island":
        raise NotImplementedError(
            "partition_graph(method='island'): islandization is not ported "
            "yet (ROADMAP Queue 1 row 6)")
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
