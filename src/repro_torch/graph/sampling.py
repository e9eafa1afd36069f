"""GraphSAGE fixed-fan-out neighbor sampling, on the host (numpy) and on
the device (torch).

Sampling with replacement from each vertex's neighbor list yields regular
(batch, fanout) shapes, which is what makes the device-side aggregation a
fixed-shape segment reduction. Both samplers draw from the same CSR view
and share one contract:

* every returned sample is valid (mask all-True): an isolated vertex
  aggregates itself, so a masked mean returns its own features rather
  than the reduction identity;
* a sampled offset never escapes its vertex's CSR range: the device
  sampler clamps ``int(u · deg)`` at ``deg - 1`` (``_fanout_offsets``).

The device sampler draws from an explicit ``torch.Generator``; its draws
are not the JAX package's ``jax.random`` draws, only its semantics are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.graph.structure import COOGraph


def host_sample(g: COOGraph, seeds: np.ndarray, fanout: int,
                *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (neighbors (B, fanout) int32, mask (B, fanout) bool)."""
    indptr, indices, _ = g.to_csr()
    return host_sample_csr(indptr, indices, seeds, fanout, seed=seed)


def host_sample_csr(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanout: int,
                    *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``host_sample`` on a raw CSR view (the serving engine samples at
    request-submit time from the CSR it already holds)."""
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


def _fanout_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """(B, fanout) float32 uniform draws × (B,) degrees → in-range neighbor
    offsets. ``int(u · deg)`` can land on ``deg`` (a ``u`` close enough to
    1.0), the first slot of the next vertex's range; the clamp pins it to
    the last real neighbor. Degree-0 rows give offset 0 (the caller
    substitutes the seed itself)."""
    deg1 = torch.clamp(deg, min=1).to(torch.int32)[:, None]
    offs = (u * deg1).to(torch.int32)
    return torch.minimum(offs, deg1 - 1)


def device_sample(indptr: torch.Tensor, indices: torch.Tensor,
                  seeds: torch.Tensor, fanout: int,
                  generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-fan-out sampling from a CSR graph on the device its tensors
    are on (``generator`` must live there too). ``host_sample``'s
    semantics: with-replacement draws are always valid (mask all-True), an
    isolated vertex's own id fills its fan-out, and offsets are
    range-clamped (``_fanout_offsets``)."""
    s = seeds.long()
    lo = indptr[s]
    deg = (indptr[s + 1] - lo).to(torch.int32)
    u = torch.rand((seeds.shape[0], fanout), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    offs = _fanout_offsets(u, deg)
    if indices.shape[0] == 0:                    # no edge at all
        nbrs = seeds[:, None].expand(-1, fanout)
    else:
        nbrs = indices[torch.clamp(lo[:, None].long() + offs.long(), 0,
                                   indices.shape[0] - 1)]
    nbrs = torch.where((deg > 0)[:, None], nbrs, seeds[:, None].to(
        nbrs.dtype))
    mask = torch.ones(nbrs.shape, dtype=torch.bool, device=nbrs.device)
    return nbrs.to(torch.int32), mask
