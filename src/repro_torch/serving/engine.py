"""The online serving engine: cross-request coalesced SSD command blocks.

A ``RequestQueue`` accumulates seed sets from independent callers
(size-or-deadline trigger), and one drain fuses every pending request into
ONE ``cgtrans.aggregate_multi`` command block: each request contributes a
K=1 self-row lookup segment and a fan-out aggregation segment, tagged with
the caller's tenant id, so the single response block scatters back to
exactly the caller that issued each segment.

* **finds-per-query**: a fused drain of N requests issues ONE find where
  the one-query-one-dispatch baseline (``fuse=False``) issues N, counted by
  ``gas.count_dispatches`` and accumulated into ``stats``;
* **bit-exactness**: fused results ≡ sequential results — neighbor samples
  are drawn at submit time and travel with the request.

The hot-vertex cache (``HotVertexCache``) intercepts K=1 self-row lookups:
hits are masked out of the command block (``-1`` dead ids) and their rows
come from the cache, bit copies of a previous find. A ``StepMonitor``
records every dispatch and an optional ``Heartbeat`` beats once per
dispatch.

The default backend is the kernel (``impl="kernel"``), the deployment; the
JAX engine defaults to its oracle (``impl="xla"``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cgtrans, gas
from repro_torch.device import DeviceLike, check_impl, resolve_device
from repro_torch.graph.sampling import host_sample_csr
from repro_torch.runtime.health import Heartbeat, StepMonitor
from repro_torch.serving.cache import HotVertexCache
from repro_torch.serving.queue import RequestQueue, ServeRequest


@dataclasses.dataclass
class ServeResult:
    """One caller's answer: its seeds' own rows + aggregated neighborhoods."""
    rid: int
    tenant: int
    self_rows: np.ndarray     # (B, F) the seeds' own feature rows
    agg_rows: np.ndarray      # (B, F) fan-out aggregation per seed
    from_cache: np.ndarray    # (B,) bool — self_row served by the hot cache


class ServingEngine:
    """Batches concurrent GraphSAGE queries into fused SSD command blocks.

    ``feats`` is the (V, F) serve-time feature table and ``indptr`` /
    ``indices`` its CSR adjacency; the table is held as float32 on
    ``device`` (ints and float64 convert once). ``fuse=False`` degrades to
    the one-query-one-dispatch baseline — same results, N× the finds.

    Not ported yet, each raising ``NotImplementedError``: ``mesh`` (sharded
    tables), ``partition="island"``, ``features="sparse"``, a compressed
    ``wire`` and sub-float32 (bf16 / f16) tables.
    """

    def __init__(
        self,
        feats: np.ndarray,
        indptr: np.ndarray,
        indices: np.ndarray,
        *,
        fanout: int = 10,
        op: gas.Op = "add",
        dataflow: str = "cgtrans",
        impl: str = "kernel",
        mesh=None,
        max_batch: int = 8,
        max_delay_s: float = 0.005,
        cache_capacity: int = 0,
        fuse: bool = True,
        scheduled: Optional[bool] = None,
        monitor: Optional[StepMonitor] = None,
        heartbeat: Optional[Heartbeat] = None,
        clock: Callable[[], float] = time.monotonic,
        sample_seed: int = 0,
        wire: str = "f32",
        features: str = "dense",
        partition: str = "interval",
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        cgtrans._check_mesh(mesh)
        if partition not in ("interval", "island"):
            raise ValueError(f"unknown partition {partition!r} "
                             "(expected 'interval' or 'island')")
        if partition == "island":
            raise NotImplementedError(
                "partition='island' is not ported yet (ROADMAP Queue 1, "
                "graph/partition.py islandize)")
        feats = np.asarray(feats)
        if feats.ndim != 2:
            raise ValueError(f"feats must be (V, F), got {feats.shape}")
        if np.issubdtype(feats.dtype, np.floating) and feats.dtype.itemsize < 4:
            raise NotImplementedError(
                f"{feats.dtype} tables are not ported yet (ROADMAP Queue 1, "
                f"bf16 serving); pass float32")
        feats = np.ascontiguousarray(feats, np.float32)
        self.n_vertices, self.n_features = feats.shape
        self.feat_dtype = feats.dtype
        self.mesh = mesh
        self.n_shards = 1
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.partition = partition
        self.feats = torch.from_numpy(feats).to(self.device).reshape(
            1, self.n_vertices, self.n_features)
        self.fanout = int(fanout)
        self.op = op
        self.dataflow = dataflow
        self.impl = check_impl(impl)
        self.scheduled = scheduled
        self.wire = cgtrans._check_wire(wire, dataflow, features)
        cgtrans._check_features(features, None)
        self.features = features
        self.fuse = fuse
        self.sample_seed = int(sample_seed)
        self.clock = clock
        self.queue = RequestQueue(max_batch=max_batch,
                                  max_delay_s=max_delay_s, clock=clock)
        self.cache = (HotVertexCache(cache_capacity)
                      if cache_capacity else None)
        self.monitor = monitor or StepMonitor()
        self.heartbeat = heartbeat
        self.stats: Dict[str, int] = {
            "queries": 0, "dispatches": 0, "command_blocks": 0,
            "find": 0, "reduce": 0, "kernel_scatter": 0,
        }
        self._next_rid = 0
        self._results: Dict[int, ServeResult] = {}

    # -- caller side --------------------------------------------------------

    def submit(self, seeds: Sequence[int],
               tenant: Optional[int] = None) -> int:
        """Enqueue one caller's seed set; returns the request id. The
        neighbor sample is drawn now (rng keyed by request id) so fused and
        sequential dispatch aggregate the identical block."""
        seeds = np.asarray(seeds, np.int32).reshape(-1)
        if seeds.size == 0:
            raise ValueError("a request needs at least one seed")
        if seeds.min() < 0 or seeds.max() >= self.n_vertices:
            raise ValueError(
                f"seed out of range [0, {self.n_vertices}): {seeds}")
        rid = self._next_rid
        self._next_rid += 1
        nbrs, mask = host_sample_csr(self.indptr, self.indices, seeds,
                                     self.fanout,
                                     seed=self.sample_seed + rid)
        self.queue.push(ServeRequest(
            rid=rid, tenant=rid if tenant is None else int(tenant),
            seeds=seeds, nbrs=nbrs, mask=mask,
            enqueued_at=self.clock()))
        return rid

    def poll(self) -> int:
        """Dispatch one batch if the queue's trigger fired; returns the
        number of requests served (0 = trigger not armed)."""
        if not self.queue.ready():
            return 0
        reqs = self.queue.drain()
        self._dispatch(reqs)
        return len(reqs)

    def flush(self) -> int:
        """Dispatch everything pending regardless of trigger state."""
        served = 0
        while len(self.queue):
            reqs = self.queue.drain()
            self._dispatch(reqs)
            served += len(reqs)
        return served

    def result(self, rid: int) -> ServeResult:
        """Pop a completed request's result (KeyError if not served yet)."""
        return self._results.pop(rid)

    # -- the fused command block -------------------------------------------

    def _shape_block(self, ids: np.ndarray, mask: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(R, K) host block → ((1, R, K) device pair, R)."""
        R, K = ids.shape
        return (torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(
                    self.device).reshape(1, R, K),
                torch.from_numpy(np.ascontiguousarray(mask, bool)).to(
                    self.device).reshape(1, R, K), R)

    def _request_segments(self, req: ServeRequest):
        """One request → its two command-block segments: the K=1 self-row
        lookup (hot-cache hits masked out) and the fan-out aggregation."""
        if self.cache is not None:
            cached_rows, hit = self.cache.lookup(req.seeds, self.n_features,
                                                 dtype=self.feat_dtype)
        else:
            cached_rows = None
            hit = np.zeros(req.seeds.shape[0], bool)
        lookup = (req.seeds[:, None].astype(np.int32), ~hit[:, None])
        fan = (req.nbrs.astype(np.int32), req.mask)
        return lookup, fan, cached_rows, hit

    def _build_blocks(self, reqs: List[ServeRequest]):
        """The fused command block for one drained batch: per request a
        (lookup, fan-out) segment pair, every segment tenant-tagged in the
        descriptor that scatter-back consults."""
        blocks, shapes, tenants, row_counts, cache_ctx = [], [], [], [], []
        for req in reqs:
            lookup, fan, cached_rows, hit = self._request_segments(req)
            for ids, mask in (lookup, fan):
                dev_ids, dev_mask, R = self._shape_block(ids, mask)
                blocks.append((dev_ids, dev_mask))
                shapes.append(tuple(dev_ids.shape[-2:]))
                row_counts.append(R)
            tenants.extend([req.tenant, req.tenant])
            cache_ctx.append((cached_rows, hit))
        desc = cgtrans.segment_descriptor(shapes, tenants)
        return blocks, desc, row_counts, cache_ctx

    def _fetch(self, blocks):
        """ONE ``aggregate_multi`` call — the engine's only dispatch site."""
        return cgtrans.aggregate_multi(
            self.feats, blocks, mesh=self.mesh, dataflow=self.dataflow,
            op=self.op, impl=self.impl, scheduled=self.scheduled,
            wire=self.wire, features=self.features)

    @torch.no_grad()
    def _dispatch(self, reqs: List[ServeRequest]) -> None:
        if not reqs:
            return
        t0 = self.clock()
        blocks, desc, row_counts, cache_ctx = self._build_blocks(reqs)
        with gas.count_dispatches() as counts:
            if self.fuse:
                outs = self._fetch(blocks)
                self.stats["command_blocks"] += 1
            else:
                # one-query-one-dispatch baseline: each request's segment
                # pair goes out as its own command block
                outs = []
                for j in range(len(reqs)):
                    outs.extend(self._fetch(blocks[2 * j:2 * j + 2]))
                self.stats["command_blocks"] += len(reqs)
        for k in ("find", "reduce", "kernel_scatter"):
            self.stats[k] += counts[k]
        self.stats["dispatches"] += 1
        self.stats["queries"] += len(reqs)

        # one device → host copy for the whole response block
        host = torch.cat([o.reshape(-1, self.n_features) for o in outs]
                         ).cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(row_counts)])
        for j, req in enumerate(reqs):
            si_look, si_fan = 2 * j, 2 * j + 1
            if desc.tenants[si_look] != req.tenant:
                raise RuntimeError(
                    f"tenant scatter-back mismatch: segment {si_look} is "
                    f"tagged {desc.tenants[si_look]}, request {req.rid} "
                    f"belongs to {req.tenant}")
            self_rows = host[offs[si_look]:offs[si_look + 1]].copy()
            agg_rows = host[offs[si_fan]:offs[si_fan + 1]].copy()
            cached_rows, hit = cache_ctx[j]
            if self.cache is not None:
                if hit.any():
                    self_rows[hit] = cached_rows[hit]
                if (~hit).any():
                    self.cache.fill(req.seeds[~hit], self_rows[~hit])
            self._results[req.rid] = ServeResult(
                rid=req.rid, tenant=req.tenant, self_rows=self_rows,
                agg_rows=agg_rows, from_cache=hit)

        self.monitor.record(self.stats["dispatches"], self.clock() - t0)
        if self.heartbeat is not None:
            self.heartbeat.touch()

    # -- observability ------------------------------------------------------

    def finds_per_query(self) -> float:
        q = self.stats["queries"]
        return self.stats["find"] / q if q else 0.0

    def health_snapshot(self) -> Dict[str, object]:
        snap: Dict[str, object] = {
            "stats": dict(self.stats),
            "finds_per_query": self.finds_per_query(),
            "queue_depth": len(self.queue),
            "monitor": self.monitor.snapshot(),
        }
        if self.cache is not None:
            snap["cache"] = self.cache.snapshot()
        return snap
