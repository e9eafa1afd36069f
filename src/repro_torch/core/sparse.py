"""Compressed-sparse feature rows — a per-row occupancy bitmap plus the
nonzero columns packed left (the SGCN / LW-GCN layout for post-ReLU
activations).

A pure codec layer, as ``core/wire.py`` is: no collectives and no kernel
calls of its own. Its consumers live in ``repro_torch.core.cgtrans``: the
find that reads a packed table (two row gathers — packed nonzeros and the
bitmap — where the dense find reads F columns) and, on the baseline
dataflow, the raw row shipment as (packed ‖ bitmap) through one
``all_to_all``.

A row ``x`` of width F becomes

* ``bitmap`` — ``ceil(F/32)`` int32 words, bit ``j`` of word ``w`` set iff
  ``x[32w + j] != 0`` (int32, never unsigned, as in the JAX package);
* ``packed`` — the nonzero values in column order, left-justified into a
  static ``capacity`` columns, aligned to ``FEAT_ALIGN`` (or
  ``NARROW_ALIGN`` when F is not a multiple of it).

The decode is positional (a cumsum over the bitmap), so the round trip is
exact whenever every row's popcount fits the capacity. ``table_capacity``
measures a table's worst row once on the host, and ``sparse_fits`` is the
static gate: a capacity that does not beat dense falls back to the dense
path unchanged.

**Subnormals are nonzeros.** ``x != 0`` holds for a subnormal ``x``, so
``table_capacity`` counts it, ``encode_rows`` packs it and ``decode_rows``
returns its bits unchanged; capacity and encode agree by construction.
PyTorch flushes no subnormal on the CPU or in its CUDA kernels, and this
module sets no flush mode. (XLA on the CPU flushes them inside the JAX
package's ``encode_rows``, so a parity test against it feeds none.)
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

#: feature modes every ``features=`` knob accepts
FEATURE_MODES = ("dense", "sparse")

#: packed-column alignment on wide tables (the JAX kernel's 128-lane tile)
FEAT_ALIGN = 128

#: alignment for narrow tables (F not a multiple of FEAT_ALIGN)
NARROW_ALIGN = 8

_WORD = 32  # bits per bitmap word


def validate_features(features: str) -> str:
    """The one place a ``features=`` string is checked."""
    if features not in FEATURE_MODES:
        raise ValueError(
            f"unknown features mode {features!r} (have {FEATURE_MODES})")
    return features


def bitmap_words(n_features: int) -> int:
    """int32 words per row of the occupancy bitmap."""
    return -(-int(n_features) // _WORD)


def _align(n_features: int) -> int:
    return FEAT_ALIGN if n_features % FEAT_ALIGN == 0 else NARROW_ALIGN


def worst_case_capacity(n_features: int, density: float) -> int:
    """Static packed capacity for a target density, rounded up to the
    alignment and capped at F."""
    a = _align(n_features)
    need = math.ceil(n_features * float(density))
    return min(int(n_features), -(-max(need, 1) // a) * a)


def table_capacity(feats) -> int:
    """The measured worst-row capacity of a table (numpy array or tensor,
    of any dtype): the max row popcount, subnormals included,
    alignment-rounded. Once per table, on the host."""
    x = feats.detach().cpu() if torch.is_tensor(feats) else np.asarray(feats)
    F = x.shape[-1]
    nz = x.reshape(-1, F) != 0
    nnz = int(nz.sum(-1).max()) if nz.shape[0] and F else 0
    a = _align(F)
    return min(int(F), -(-max(nnz, 1) // a) * a)


def sparse_fits(capacity: int, n_features: int) -> bool:
    """Static gate: do ``capacity + bitmap_words(F)`` 32-bit lanes per row
    beat the F dense ones?"""
    return int(capacity) + bitmap_words(n_features) < int(n_features)


def density_stats(x) -> dict:
    """Measured density of a feature block, as host numbers."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    total = int(a.size)
    nnz = int((a != 0).sum())
    return {"nnz": nnz, "total": total,
            "density": (nnz / total) if total else 0.0}


def _bit_weights(device) -> torch.Tensor:
    return torch.bitwise_left_shift(
        torch.ones(_WORD, dtype=torch.int64, device=device),
        torch.arange(_WORD, dtype=torch.int64, device=device))


def encode_rows(x: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, F) rows → (packed (…, capacity) in x's dtype, bitmap (…, W)
    int32). Rows whose popcount exceeds ``capacity`` lose their trailing
    nonzeros; the ``sparse_fits`` / ``table_capacity`` gate keeps the entry
    points from ever doing so."""
    F = x.shape[-1]
    W = bitmap_words(F)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, F)
    R = x2.shape[0]
    nz = x2 != 0
    bits = torch.nn.functional.pad(nz, (0, W * _WORD - F))
    words = (bits.reshape(R, W, _WORD).to(torch.int64)
             * _bit_weights(x.device)).sum(-1)
    # the uint32 word's bits as int32 (two's complement)
    bitmap = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    pos = torch.cumsum(nz, dim=-1, dtype=torch.int32) - 1
    col = torch.where(nz & (pos < capacity), pos,
                      torch.full((), capacity, dtype=torch.int32,
                                 device=x.device))
    # zeros and over-capacity spill land in a scratch column, dropped below
    packed = torch.zeros((R, capacity + 1), dtype=x.dtype, device=x.device)
    packed.scatter_(1, col.long(), x2)
    return (packed[:, :capacity].reshape(*lead, capacity),
            bitmap.reshape(*lead, W))


def _bits(bitmap: torch.Tensor) -> torch.Tensor:
    """(…, W) int32 bitmap → (…, W, 32) int32 bits. An arithmetic shift
    of the int32 word leaves bit j at the bottom, sign or not."""
    shift = torch.arange(_WORD, dtype=torch.int32, device=bitmap.device)
    return torch.bitwise_right_shift(bitmap[..., None], shift) & 1


def _unpack_bits(bitmap: torch.Tensor, n_features: int) -> torch.Tensor:
    """(…, W) int32 bitmap → (…, F) bool occupancy."""
    bits = _bits(bitmap.to(torch.int32))
    return bits.reshape(*bitmap.shape[:-1], bitmap.shape[-1] * _WORD)[
        ..., :n_features].to(torch.bool)


def decode_rows(packed: torch.Tensor, bitmap: torch.Tensor,
                n_features: int) -> torch.Tensor:
    """Inverse of ``encode_rows``: positional unpack through a cumsum over
    the occupancy bits, exact whenever the row's popcount fit the packed
    capacity."""
    C = packed.shape[-1]
    bits = _unpack_bits(bitmap, n_features)
    pos = torch.cumsum(bits, dim=-1, dtype=torch.int32) - 1
    vals = torch.take_along_dim(packed, torch.clamp(pos, 0, C - 1).long(),
                                dim=-1)
    return torch.where(bits & (pos < C), vals,
                       torch.zeros((), dtype=packed.dtype,
                                   device=packed.device))


def popcount(bitmap: torch.Tensor) -> torch.Tensor:
    """(…, W) int32 bitmap → (…,) int32 set-bit count (the packed length
    the decode consumes)."""
    return _bits(bitmap.to(torch.int32)).sum(dim=(-1, -2)).to(torch.int32)
