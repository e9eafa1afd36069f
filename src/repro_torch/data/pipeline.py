"""GraphSAGE minibatches (seed ids + sampled 1/2-hop neighborhoods + labels)
from a COO graph. Batches carry ids only: CGTrans keeps the raw features on
the storage tier. Deterministic in (seed, step), so a restarted run
regenerates the exact batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.graph.structure import COOGraph


@dataclasses.dataclass
class GraphBatchStream:
    """Minibatch sampler for 2-layer GraphSAGE (ids only on the wire)."""

    graph: COOGraph
    labels: np.ndarray            # (V,) int32 class labels
    n_parts: int                  # data-axis shards (seed sharding)
    batch_per_part: int
    k1: int = 10
    k2: int = 10
    seed: int = 0

    def __post_init__(self):
        self.indptr, self.indices, _ = self.graph.to_csr()

    def _sample(self, rng, seeds: np.ndarray, k: int):
        lo = self.indptr[seeds]
        hi = self.indptr[seeds + 1]
        deg = (hi - lo).astype(np.int64)
        offs = (rng.random((len(seeds), k)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
        idx = np.minimum(lo[:, None] + offs, len(self.indices) - 1)
        nbrs = self.indices[idx].astype(np.int32)
        mask = np.broadcast_to(deg[:, None] > 0, nbrs.shape)
        nbrs = np.where(mask, nbrs, seeds[:, None].astype(np.int32))
        return nbrs, mask

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        P, B = self.n_parts, self.batch_per_part
        seeds = rng.integers(0, self.graph.n_vertices, (P, B)).astype(np.int32)
        flat = seeds.reshape(-1)
        n1, m1 = self._sample(rng, flat, self.k1)
        lay1 = np.concatenate([flat[:, None], n1], axis=1).reshape(-1)
        n2, m2 = self._sample(rng, lay1, self.k2)
        return {
            "seeds": seeds,
            "nbrs1": n1.reshape(P, B, self.k1),
            "mask1": m1.reshape(P, B, self.k1),
            "nbrs2": n2.reshape(P, B * (1 + self.k1), self.k2),
            "mask2": m2.reshape(P, B * (1 + self.k1), self.k2),
            "labels": self.labels[seeds].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_node_labels(feats: np.ndarray, n_classes: int, seed: int = 0) -> np.ndarray:
    """Learnable labels: argmax of a fixed random projection of features."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((feats.shape[1], n_classes)).astype(np.float32)
    return np.argmax(feats @ proj, axis=1).astype(np.int32)
