"""GraphSAGE fixed-fan-out neighbor sampling on the host (numpy).

Sampling with replacement from each vertex's neighbor list yields regular
(batch, fanout) shapes, which is what makes the device-side aggregation a
fixed-shape segment reduction. Every returned sample is valid (mask
all-True): an isolated vertex aggregates itself, so a masked mean returns
its own features rather than the reduction identity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def host_sample_csr(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanout: int,
                    *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (neighbors (B, fanout) int32, mask (B, fanout) bool) drawn
    from a CSR view (the serving engine samples at request-submit time from
    the CSR it already holds)."""
    rng = np.random.default_rng(seed)
    B = seeds.shape[0]
    out = np.zeros((B, fanout), np.int32)
    mask = np.ones((B, fanout), bool)
    for i, s in enumerate(seeds):
        lo, hi = int(indptr[s]), int(indptr[s + 1])
        deg = hi - lo
        if deg == 0:
            out[i] = s  # isolated vertex aggregates itself — and its
            continue    # self-samples are VALID (mask True), not identity
        out[i] = indices[lo + rng.integers(0, deg, fanout)]
    return out, mask
