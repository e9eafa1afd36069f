"""Hot-vertex embedding cache: an LRU of feature rows keyed by vertex id.

Degree-skewed graphs concentrate queries on a small set of hot vertices
(I-GCN's islandization argument), so a small LRU of previously-fetched
feature rows removes a large fraction of the SSD self-row finds. The cache
holds EXACT rows (bit copies of what the SSD find returned — features are
static at serve time), so a cache hit is indistinguishable from a fetch:
the serving tier asserts hit rows ≡ SSD-find rows bit-exactly.

Only the K=1 self-row lookups consult the cache; fan-out aggregation
segments always dispatch (their result is a *reduction*, not a row, so a
row cache cannot serve them).

Counters are the claim surface: ``hits``/``misses``/``hit_rate`` feed the
bench's hot-cache row.

Rows are numpy arrays, or ``torch.bfloat16`` CPU tensors for a bfloat16
table (``ServeResult`` says why); either is kept as a bit copy.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import numpy as np
import torch


class HotVertexCache:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rows: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, vid: int) -> bool:
        return int(vid) in self._rows

    def lookup(self, ids: np.ndarray, n_features: int, dtype=np.float32,
               touch: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(B,) ids → ((B, F) rows, (B,) hit mask). Miss rows are zero and
        hit rows are refreshed to most-recently-used; counters tick one per
        id (repeated ids in one batch each count — they each would have
        been an SSD find). ``dtype`` is the serving table's feature dtype —
        the result block the engine substitutes hit rows into — so hits
        stay bit copies on non-f32 tables (bf16 serving) instead of being
        silently promoted; ``torch.bfloat16`` gives a tensor.
        ``touch=False`` reads without ticking the counters or refreshing
        the order."""
        ids = np.asarray(ids).reshape(-1)
        shape = (ids.shape[0], n_features)
        rows = (torch.zeros(shape, dtype=dtype)
                if isinstance(dtype, torch.dtype) else np.zeros(shape, dtype))
        hit = np.zeros(ids.shape[0], bool)
        for i, vid in enumerate(ids):
            row = self._rows.get(int(vid))
            if row is None:
                if touch:
                    self.misses += 1
                continue
            if touch:
                self._rows.move_to_end(int(vid))
                self.hits += 1
            rows[i] = row
            hit[i] = True
        return rows, hit

    def fill(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Insert fetched (id, row) pairs; least-recently-used rows evict
        once capacity is exceeded. Rows are stored in THEIR OWN dtype —
        bit copies of what the find returned is the whole exactness claim
        (an f32 coercion here used to break it for bf16 tables)."""
        ids = np.asarray(ids).reshape(-1)
        for vid, row in zip(ids, rows):
            key = int(vid)
            if key in self._rows:
                self._rows.move_to_end(key)
            self._rows[key] = (row.clone() if torch.is_tensor(row)
                               else np.array(row, copy=True))
            if len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
                self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"capacity": self.capacity, "resident": len(self._rows),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}
