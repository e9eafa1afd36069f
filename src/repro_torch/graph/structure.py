"""Graph containers: COO (the paper's storage format) and CSR views.

Host-side representation is numpy (the "SSD-resident" data); device-side
mini-batches are padded, fixed-shape tensors (regular shapes are the
paper's own load-balancing argument for GraphSAGE sampling). A copy of the
JAX package's module of the same name, so the two packages build identical
graphs from one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class COOGraph:
    """Edge list graph. src/dst: (E,) int32; weights optional (E,) float32."""

    n_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weights: Optional[np.ndarray] = None
    features: Optional[np.ndarray] = None  # (V, F) vertex features

    def __post_init__(self):
        assert self.src.shape == self.dst.shape
        self.src = self.src.astype(np.int32)
        self.dst = self.dst.astype(np.int32)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def degree_out(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices)

    def degree_in(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_vertices)

    def sort_by_dst(self) -> "COOGraph":
        order = np.argsort(self.dst, kind="stable")
        return COOGraph(
            self.n_vertices, self.src[order], self.dst[order],
            None if self.weights is None else self.weights[order], self.features)

    def sort_by_src(self) -> "COOGraph":
        order = np.argsort(self.src, kind="stable")
        return COOGraph(
            self.n_vertices, self.src[order], self.dst[order],
            None if self.weights is None else self.weights[order], self.features)

    def to_csr(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Returns (indptr (V+1,), indices=dst sorted by src, weights)."""
        g = self.sort_by_src()
        indptr = np.zeros(self.n_vertices + 1, np.int64)
        np.cumsum(np.bincount(g.src, minlength=self.n_vertices), out=indptr[1:])
        return indptr, g.dst, g.weights

    def undirected(self) -> "COOGraph":
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = None if self.weights is None else np.concatenate([self.weights] * 2)
        return COOGraph(self.n_vertices, src, dst, w, self.features)
