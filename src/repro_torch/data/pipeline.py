"""Deterministic data pipelines, numpy copies of the JAX package's.

* ``TokenStream`` — synthetic LM token batches, deterministic in (seed,
  step, host), resumable from any step (stateless indexing: a restarted
  trainer regenerates the exact batch).
* ``ShardedTokenFiles`` — file-backed token shards + manifest: writer and
  resumable reader with per-host sharding, on the JAX package's file
  layout (either package reads the other's files).
* ``GraphBatchStream`` — GraphSAGE minibatches (seed ids + sampled 1/2-hop
  neighborhoods + labels) from a COO graph. Batches carry ids only:
  CGTrans keeps the raw features on the storage tier.

Every batch is array-equal to the JAX package's for the same arguments.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator

import numpy as np

from repro_torch.graph.structure import COOGraph


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    host: int = 0
    n_hosts: int = 1
    with_frames: int = 0      # whisper: frame-embedding stub (enc_seq)
    with_vision: int = 0      # vlm: patch-embedding stub (vision_seq)
    d_model: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq_len + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.with_frames:
            out["frames"] = rng.standard_normal(
                (self.batch, self.with_frames, self.d_model)
            ).astype(np.float32)
        if self.with_vision:
            out["vision"] = rng.standard_normal(
                (self.batch, self.with_vision, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedTokenFiles:
    """npy token shards + JSON manifest; deterministic resumable reads."""

    def __init__(self, root: str):
        self.root = root
        self.manifest_path = os.path.join(root, "manifest.json")

    @staticmethod
    def write(root: str, tokens: np.ndarray, shard_size: int = 1 << 16
              ) -> None:
        os.makedirs(root, exist_ok=True)
        shards = []
        for i in range(0, len(tokens), shard_size):
            name = f"shard_{i // shard_size:05d}.npy"
            np.save(os.path.join(root, name), tokens[i:i + shard_size])
            shards.append(name)
        tmp = os.path.join(root, ".manifest.tmp")
        with open(tmp, "w") as f:
            json.dump({"shards": shards, "total": len(tokens)}, f)
        os.replace(tmp, os.path.join(root, "manifest.json"))

    def reader(self, batch: int, seq_len: int, *, start_step: int = 0,
               host: int = 0, n_hosts: int = 1
               ) -> Iterator[Dict[str, np.ndarray]]:
        with open(self.manifest_path) as f:
            manifest = json.load(f)
        data = np.concatenate(
            [np.load(os.path.join(self.root, s)) for s in manifest["shards"]])
        data = data.reshape(-1)
        span = batch * (seq_len + 1)
        step = start_step
        while True:
            off = ((step * n_hosts + host) * span) % max(len(data) - span, 1)
            chunk = data[off:off + span].reshape(batch, seq_len + 1
                                                 ).astype(np.int32)
            yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
            step += 1


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
