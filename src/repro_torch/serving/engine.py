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

On a sharded ``mesh`` every rank runs the same queue, sampler and hot
cache from the same seed (replicated host state, SPMD) and holds its own
``(1, V/P, F)`` table shard. Each segment pads to ``P·r`` rows, as the
JAX engine pads it, and each rank issues its ``r`` rows; the drain is one
sharded ``aggregate_multi`` (one ``all_gather`` + one ``all_to_all``,
whatever the number of requests), and one ``all_gather`` of the finished
rows (``result_gather``) brings every rank the whole response for
scatter-back, where the JAX host reads the seed-sharded result. The queue's
trigger is rank 0's, broadcast once per ``poll`` (``trigger_broadcast``),
so a clock read differently on two ranks cannot split their drains.

The table is served in its own dtype where it is float32, bfloat16 or
float16, as the JAX engine serves any float table of at most 4 bytes an
element; integer and float64 tables are served as float32. A bfloat16
table arrives as a ``torch.bfloat16`` tensor or as a numpy array whose
dtype is named ``bfloat16`` (``ml_dtypes``'s, read through its bits: the
port does not import ``ml_dtypes``). ``fetch_callable`` hands out the
fused fetch of a drain without running it, for counting.

The default backend is the kernel (``impl="kernel"``), the deployment; the
JAX engine defaults to its oracle (``impl="xla"``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cgtrans, collectives, gas
from repro_torch.core import sparse as sparsefmt
from repro_torch.device import DeviceLike, check_impl, resolve_device
from repro_torch.graph.partition import islandize
from repro_torch.graph.sampling import host_sample_csr
from repro_torch.graph.structure import COOGraph
from repro_torch.runtime.health import Heartbeat, StepMonitor
from repro_torch.serving.cache import HotVertexCache
from repro_torch.serving.queue import RequestQueue, ServeRequest


# the table dtypes served as they come (a float of at most 4 bytes an
# element, the JAX engine's rule); any other table is served as float32
SERVED_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _served_dtype(feats) -> torch.dtype:
    """The device dtype of a table given as a numpy array or a tensor."""
    return SERVED_DTYPES.get(str(feats.dtype).removeprefix("torch."),
                             torch.float32)


def _table_rows(feats, rows, dtype: torch.dtype) -> torch.Tensor:
    """A copy of rows ``rows`` of the table (a numpy array or a tensor) as
    a tensor of ``dtype``. A numpy bfloat16 array is read through its bits;
    of a memory-mapped table only these rows are read."""
    part = feats[rows]
    if torch.is_tensor(part):
        return part.to(dtype=dtype, copy=True)
    if part.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(part).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(part, np.float16 if dtype ==
                                     torch.float16 else np.float32))


def _host(rows: torch.Tensor):
    """Result rows on the host: a numpy array, or a ``torch.bfloat16`` CPU
    tensor, numpy having no bfloat16 of its own."""
    rows = rows.cpu()
    return rows if rows.dtype == torch.bfloat16 else rows.numpy()


@dataclasses.dataclass
class ServeResult:
    """One caller's answer: its seeds' own rows + aggregated neighborhoods.

    The rows are in the served table's dtype (``ServingEngine.feat_dtype``):
    numpy arrays of float32 or float16, or, for a bfloat16 table,
    ``torch.bfloat16`` CPU tensors (numpy has no bfloat16 without
    ``ml_dtypes``, which the port does not import); the hot cache keeps
    its rows in the same form, as bit copies."""
    rid: int
    tenant: int
    self_rows: np.ndarray     # (B, F) the seeds' own feature rows
    agg_rows: np.ndarray      # (B, F) fan-out aggregation per seed
    from_cache: np.ndarray    # (B,) bool — self_row served by the hot cache


class ServingEngine:
    """Batches concurrent GraphSAGE queries into fused SSD command blocks.

    ``feats`` is the (V, F) serve-time feature table (a numpy array or a
    tensor) and ``indptr`` / ``indices`` its CSR adjacency; the table is
    held on ``device`` in its own dtype if that is float32, bfloat16 or
    float16, else as float32 (ints and float64 convert once), and
    ``feat_dtype`` is the result rows' dtype on the host (``ServeResult``).
    ``fuse=False`` degrades to the one-query-one-dispatch baseline — same
    results, N× the finds. ``mesh`` shards the table along the ``data`` axis (``V`` must divide
    by its size; ``device`` is then the mesh's).

    ``wire`` and ``features`` pass to every command block as in the JAX
    engine; ``features="sparse"`` measures the table's packed capacity once
    (``sparse.table_capacity`` over the whole table as served, so every
    rank of a mesh holds the same). Unsharded both are no-ops, bit for bit.

    ``partition="island"`` islandizes the table layout once at build
    (``graph.partition.islandize`` over the CSR, ``n_shards`` parts,
    ``pad_multiple=1``): each rank then holds a community's rows. The CSR,
    the sampler, the hot cache and every caller-visible id stay in
    original ids; ``_request_segments`` translates the ids entering the
    command block, and rows come back positionally, so results are the
    interval engine's bit for bit.
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
        sharded = cgtrans.is_sharded(mesh)
        self.device = mesh.device if sharded else resolve_device(device)
        if partition not in ("interval", "island"):
            raise ValueError(f"unknown partition {partition!r} "
                             "(expected 'interval' or 'island')")
        if not torch.is_tensor(feats):
            feats = np.asarray(feats)
        if feats.ndim != 2:
            raise ValueError(f"feats must be (V, F), got {tuple(feats.shape)}")
        self.n_vertices, self.n_features = feats.shape
        dtype = _served_dtype(feats)
        self.feat_dtype = (dtype if dtype == torch.bfloat16 else
                           np.dtype(str(dtype).removeprefix("torch.")))
        self.mesh = mesh if sharded else None
        self.n_shards = mesh.size if sharded else 1
        if self.n_vertices % self.n_shards:
            raise ValueError(
                f"V={self.n_vertices} must divide the data axis "
                f"({self.n_shards}-way) — pad the table at load time")
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.partition = partition
        part = self.n_vertices // self.n_shards
        lo = mesh.rank * part if sharded else 0
        self.islands = None
        self._relabel: Optional[np.ndarray] = None
        rows = slice(lo, lo + part)
        if partition == "island":
            src = np.repeat(np.arange(self.n_vertices, dtype=np.int32),
                            np.diff(self.indptr))
            self.islands = islandize(
                COOGraph(self.n_vertices, src,
                         self.indices.astype(np.int32)),
                self.n_shards, pad_multiple=1)
            self._relabel = self.islands.relabel
            # this rank's rows of ``relabel_rows(feats)``
            rows = self.islands.inverse[lo:lo + part]
        # a copy of this rank's rows only (of a memory-mapped table, the
        # rest is never read), converted once
        self.feats = _table_rows(feats, rows, dtype).to(self.device).reshape(
            1, part, self.n_features)
        self.fanout = int(fanout)
        self.op = op
        self.dataflow = dataflow
        self.impl = check_impl(impl)
        self.scheduled = scheduled
        self.wire = cgtrans._check_wire(wire, dataflow, features)
        self.features = sparsefmt.validate_features(features)
        self.sparse_capacity = None
        if features == "sparse":
            # a served dtype has its own nonzeros; a converted table is
            # measured as served (float64 values can round to 0)
            served = str(feats.dtype).removeprefix("torch.") in SERVED_DTYPES
            self.sparse_capacity = sparsefmt.table_capacity(
                feats if served else _table_rows(feats, slice(None), dtype))
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
        number of requests served (0 = trigger not armed). On a mesh every
        rank calls it and rank 0's trigger decides."""
        if not self._agree(self.queue.ready()):
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

    def _agree(self, ready: bool) -> bool:
        """Rank 0's trigger decision, on every rank of a mesh."""
        if self.mesh is None:
            return ready
        flag = torch.tensor([int(ready) if self.mesh.rank == 0 else 0],
                            dtype=torch.int32, device=self.device)
        return bool(collectives.all_reduce(
            flag, self.mesh, name="trigger_broadcast").item())

    # -- the fused command block -------------------------------------------

    def _shape_block(self, ids: np.ndarray, mask: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(R, K) host block → (this rank's (1, r, K) device pair, R).
        Rows pad to a multiple of the shard count with all-masked rows —
        they ride the ``-1`` dead-id encoding, reduce to the op identity
        and are sliced off on return."""
        R, K = ids.shape
        P = self.n_shards
        r = -(-R // P)
        pad = P * r - R
        if pad:
            ids = np.concatenate([ids, np.zeros((pad, K), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, K), bool)])
        lo = (self.mesh.rank if self.mesh is not None else 0) * r
        return (torch.from_numpy(np.ascontiguousarray(
                    ids[lo:lo + r], np.int32)).to(self.device).reshape(
                        1, r, K),
                torch.from_numpy(np.ascontiguousarray(
                    mask[lo:lo + r], bool)).to(self.device).reshape(1, r, K),
                R)

    def _request_segments(self, req: ServeRequest, touch: bool = True):
        """One request → its two command-block segments: the K=1 self-row
        lookup (hot-cache hits masked out) and the fan-out aggregation.
        ``touch=False`` reads the cache without counting or reordering."""
        if self.cache is not None:
            cached_rows, hit = self.cache.lookup(req.seeds, self.n_features,
                                                 dtype=self.feat_dtype,
                                                 touch=touch)
        else:
            cached_rows = None
            hit = np.zeros(req.seeds.shape[0], bool)
        lookup_ids = req.seeds[:, None].astype(np.int32)
        fan_ids = req.nbrs.astype(np.int32)
        if self._relabel is not None:
            # into the islandized table's id space at the command-block
            # door; rows come back positionally, so the cache above stays
            # keyed on original ids and scatter-back needs no un-relabel
            lookup_ids = self._relabel[lookup_ids]
            fan_ids = self._relabel[fan_ids]
        lookup = (lookup_ids, ~hit[:, None])
        fan = (fan_ids, req.mask)
        return lookup, fan, cached_rows, hit

    def _build_blocks(self, reqs: List[ServeRequest], touch: bool = True):
        """The fused command block for one drained batch: per request a
        (lookup, fan-out) segment pair, every segment tenant-tagged in the
        descriptor that scatter-back consults."""
        blocks, shapes, tenants, row_counts, cache_ctx = [], [], [], [], []
        for req in reqs:
            lookup, fan, cached_rows, hit = self._request_segments(req, touch)
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
        return self._aggregate(self.feats, blocks)

    def _aggregate(self, feats, blocks):
        return cgtrans.aggregate_multi(
            feats, blocks, mesh=self.mesh, dataflow=self.dataflow,
            op=self.op, impl=self.impl, scheduled=self.scheduled,
            wire=self.wire, features=self.features,
            sparse_capacity=self.sparse_capacity)

    def fetch_callable(self, reqs: Optional[List[ServeRequest]] = None):
        """(fn, args) of the fused fetch a drain of ``reqs`` (default: the
        queue's pending requests) would dispatch, built without touching
        engine state (the hot cache is read without counting or
        reordering). ``fn(*args)`` runs that fetch; under
        ``gas.count_dispatches()`` and ``collectives.count_collectives()``
        it counts the finds, scatters and collectives of one drain. On a
        mesh every rank calls both."""
        reqs = list(self.queue._pending) if reqs is None else list(reqs)
        if not reqs:
            raise ValueError("nothing pending to trace")
        blocks, _, _, _ = self._build_blocks(reqs, touch=False)
        return self._aggregate, (self.feats, tuple(blocks))

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

        segs = self._segment_rows(outs, row_counts)
        for j, req in enumerate(reqs):
            si_look, si_fan = 2 * j, 2 * j + 1
            if desc.tenants[si_look] != req.tenant:
                raise RuntimeError(
                    f"tenant scatter-back mismatch: segment {si_look} is "
                    f"tagged {desc.tenants[si_look]}, request {req.rid} "
                    f"belongs to {req.tenant}")
            self_rows, agg_rows = segs[si_look], segs[si_fan]
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

    def _segment_rows(self, outs, row_counts) -> List[np.ndarray]:
        """Each segment's (R_i, F) rows on the host (``_host``), padding
        dropped, writable: one device → host copy of the whole response
        block, after one ``result_gather`` on a mesh."""
        rows = torch.cat([o.reshape(-1, self.n_features) for o in outs])
        if self.mesh is None:
            every = _host(rows[None])
        else:
            every = _host(collectives.all_gather(rows, self.mesh,
                                                 name="result_gather"))
        segs, off = [], 0
        for o, R in zip(outs, row_counts):   # rank-major → segment rows
            r = o.shape[1]
            seg = every[:, off:off + r].reshape(-1, self.n_features)[:R]
            segs.append(seg.clone() if torch.is_tensor(seg) else seg.copy())
            off += r
        return segs

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
