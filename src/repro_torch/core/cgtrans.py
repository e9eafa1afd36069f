"""CGTrans — Compressive Graph Transmission (paper §3.2), unsharded and
over a ``data`` mesh.

Vertex features live owner-sharded on the storage tier, laid out as
``(P, part, F)``; each shard owns an interval of vertices and every edge
whose source lies in it, so gathers are local. Two dataflows over the same
math:

* ``baseline`` (GCNAX) ships the raw gathered rows to the destination's
  owner and aggregates there: bytes ∝ E·F (or B·K·F sampled);
* ``cgtrans`` aggregates at the owner into per-destination partials and
  ships only those: bytes ∝ V·F (or B·F).

**Full-graph (GCN).** ``aggregate_edges`` reduces the edge COO stream
``out[v] = ⊕_{(u,v,w)} w · feats[u]``. On a mesh the cgtrans combine is a
``reduce_scatter`` of the (V, F) partials for add on the f32 wire, an
``all_to_all`` plus a local sum on a narrow wire, and an ``all_to_all``
plus a local extremum for max / min / or; the baseline all-gathers the raw
weighted and masked payload, its destinations and its mask, and scatters
the owned interval on the destination side. ``edge_stream`` owns the
edge stream: it flattens the partitions (or takes the rank's slice), bins
the stream by destination row block and applies the permutation, once per
forward on every path; ``aggregate_stream`` is one layer's aggregation over
it, and ``aggregate_edges`` the two in one call.

**Sampled (GraphSAGE).** ``aggregate_multi`` fuses several request segments
of different fan-out (e.g. ``sage_forward``'s K=1 self-row lookup and its
2-hop block) into ONE command block — one combined gather
(``_multi_find``), then a per-segment seed reduction: a K=1 segment is a
pure find with no kernel, a K>1 segment is one FAST-GAS scatter, on the
banded walk when ``scheduled`` (the seed stream ``repeat(arange(R), K)``
is destination-binned by construction, so its schedule needs no sort). On
a mesh: ONE ``all_gather`` of the concatenated ``-1``-encoded id stream,
ONE ``_multi_find`` against the local rows, ONE ``all_to_all`` of the
(n, R_tot, F) partials with the add counts as one extra column
(``cgtrans``); or the raw rows' and the ownership bits' ``all_to_all``,
reduced at the seed's owner (``baseline``). ``request_chunk`` streams each
segment through the command block that many rows at a time, bit for bit
with the unchunked block.

On a ``repro_torch.launch.mesh.DataMesh`` of P > 1 ranks each rank runs the
JAX package's ``shard_map`` body on its own slice: ``feats`` is the rank's
``(1, part, F)`` rows, every per-shard array the rank's ``[rank:rank + 1]``
slice, and the result the rank's slice; the collectives are those of
``repro_torch.core.collectives``.

**The compressed wire and compressed-sparse features.** ``wire="bf16"`` or
``"int8"`` (``core/wire.py``) ships the cgtrans partials encoded through
``_wire_all_to_all`` (its backward ships the cotangent through the same
wire) and the request ids as int16 deltas where the vertex range allows;
``features="sparse"`` (``core/sparse.py``) reads the table through the
packed layout (``_find``) and, on the sampled baseline, ships the raw rows
packed (``_sparse_all_to_all``). Without a mesh both knobs are validated
no-ops, bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives, gas
from repro_torch.core import sparse as sparsefmt
from repro_torch.core import wire as wirefmt
from repro_torch.device import check_impl
from repro_torch.kernels import entries
from repro_torch.kernels.gas_scatter import ops as gas_ops
from repro_torch.launch.mesh import DataMesh, Mesh
from repro_torch.runtime import trace


# ---------------------------------------------------------------------------
# the compressed wire: the codecs are core/wire.py's; the one collective
# they wrap is here
# ---------------------------------------------------------------------------

def _wire_identity(op: gas.Op) -> float:
    """The op identity non-finite int8 codes decode back to (±inf for the
    max/min identity rows; add/or partials are finite)."""
    return float(gas._INIT[op]) if op in ("max", "min") else 0.0


def _wired_a2a(x: torch.Tensor, mesh, wire: str, identity: float,
               n_exact: int) -> torch.Tensor:
    enc = wirefmt.encode_payload(x, wire, identity=identity, n_exact=n_exact)
    parts = collectives.all_to_all(enc, mesh)
    return wirefmt.decode_payload(parts, wire, identity=identity,
                                  n_exact=n_exact, out_dtype=x.dtype)


class _WireAllToAll(torch.autograd.Function):
    """``all_to_all`` with the payload encoded for transport and decoded
    (f32 math) on arrival; the backward ships the cotangent through the
    same wire with identity 0 (JAX ``_wire_all_to_all``'s custom VJP), so
    the codec's round / where never meet autograd."""

    @staticmethod
    def forward(ctx, x, mesh, wire, identity, n_exact):
        ctx.mesh, ctx.wire, ctx.n_exact = mesh, wire, n_exact
        ctx.suspended = gas_ops.counting_suspended()
        return _wired_a2a(x, mesh, wire, identity, n_exact)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return (_wired_a2a(g, ctx.mesh, ctx.wire, 0.0, ctx.n_exact),
                    None, None, None, None)


def _wire_all_to_all(x: torch.Tensor, mesh, wire: str,
                     identity: float = 0.0, n_exact: int = 0):
    return _WireAllToAll.apply(x, mesh, wire, identity, n_exact)


def _check_wire(wire: str, dataflow: str, features: str = "dense") -> str:
    """Validate a ``wire=`` knob. The baseline dataflow ships raw f32 by
    definition; with ``features="sparse"`` its shipment is the packed row
    block, which quantizes like a partial block, so a narrow wire is legal
    there too."""
    wirefmt.validate(wire)
    if wire != "f32" and dataflow == "baseline" and features != "sparse":
        raise ValueError(
            "wire compression is a cgtrans-dataflow mechanism; the baseline "
            "strawman ships raw f32 by definition (features='sparse' is the "
            "exception: packed nonzeros quantize like partials)")
    return wire


# ---------------------------------------------------------------------------
# compressed-sparse features: the codec is core/sparse.py's; the find that
# reads a packed table and the all_to_all that ships a packed block are here
# ---------------------------------------------------------------------------

def _resolve_sparse(features: str, sparse_capacity: Optional[int],
                    n_features: int) -> Optional[int]:
    """``features=`` → the packed capacity to run with, or None for the
    dense path. ``"sparse"`` needs ``sparse_capacity`` (from
    ``sparse.table_capacity``); a capacity that fails ``sparse_fits``
    falls back to the dense path unchanged."""
    if sparsefmt.validate_features(features) == "dense":
        if sparse_capacity is not None:
            raise ValueError(
                "sparse_capacity= only applies with features='sparse'")
        return None
    if sparse_capacity is None:
        raise ValueError(
            "features='sparse' needs sparse_capacity= — measure it once "
            "with sparse.table_capacity(feats) (a static host-side int)")
    cap = int(sparse_capacity)
    if cap < 1:
        raise ValueError(f"sparse_capacity must be ≥ 1, got {cap}")
    return cap if sparsefmt.sparse_fits(cap, n_features) else None


class _SparseGather(torch.autograd.Function):
    """Row gather from the packed table: packed nonzeros and the bitmap,
    ``capacity + ceil(F/32)`` lanes per row where the dense find reads F,
    decoded bit for bit. The backward is the dense gather's scatter-add of
    the cotangent: one kernel scatter on the kernel route, ``index_add_``
    on ``ref``."""

    @staticmethod
    def forward(ctx, table, ids, capacity, impl):
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.dtype, ctx.impl = table.shape[0], table.dtype, impl
        ctx.suspended = gas_ops.counting_suspended()
        packed, bitmap = sparsefmt.encode_rows(table, capacity)
        i = ids.long()
        return sparsefmt.decode_rows(packed[i], bitmap[i],
                                     table.shape[-1]).to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1]).to(torch.float32)
        flat = ids.reshape(-1)
        with gas_ops.suspend_counting(ctx.suspended):
            if ctx.impl == "kernel":
                dtab = gas._scatter_weighted_impl(flat, gf, None, None,
                                                  ctx.n_rows, "add", "kernel")
            else:
                dtab = torch.zeros((ctx.n_rows, gf.shape[-1]),
                                   dtype=torch.float32, device=gf.device
                                   ).index_add_(0, flat.long(), gf)
        return dtab.to(ctx.dtype), None, None, None


def _find(table: torch.Tensor, ids: torch.Tensor, *, impl: str,
          sparse_cap: Optional[int] = None) -> torch.Tensor:
    """The find of find-and-compute: dense tables through
    ``gas.gas_gather``; a packed capacity swaps in the compressed-table
    gather. Ticks ``find`` once either way."""
    with trace.span("gas.find", table):
        if sparse_cap is None:
            return gas.gas_gather(table, ids, impl=impl)
        gas._tick("find")
        entries.note("find", table)
        return _SparseGather.apply(table, ids, sparse_cap, check_impl(impl))


def _sparse_ship(x: torch.Tensor, mesh, wire: str, capacity: int):
    """Pack a raw (n, N, F) row block, ship (packed ‖ bitmap) through ONE
    ``all_to_all`` and decode on arrival (f32 math on a narrow wire). The
    bitmap travels as exact bitcast lanes, so only nonzero values quantize.
    """
    F = x.shape[-1]
    packed, bitmap = sparsefmt.encode_rows(x, capacity)
    if wire == "f32":
        payload = torch.cat([packed, bitmap.view(x.dtype)], dim=-1)
        parts = collectives.all_to_all(payload, mesh)
        bm = parts[..., capacity:].contiguous().view(torch.int32)
        return sparsefmt.decode_rows(parts[..., :capacity], bm, F)
    enc = wirefmt.encode_payload(packed.to(torch.float32), wire)
    bits = bitmap.contiguous().view(enc.dtype)            # (…, W·4/size)
    nb = bits.shape[-1]
    parts = collectives.all_to_all(torch.cat([enc, bits], dim=-1), mesh)
    pk = wirefmt.decode_payload(parts[..., :parts.shape[-1] - nb], wire)
    bm = parts[..., parts.shape[-1] - nb:].contiguous().view(torch.int32)
    return sparsefmt.decode_rows(pk, bm, F).to(x.dtype)


class _SparseAllToAll(torch.autograd.Function):
    """The baseline's raw-row shipment on sparse features; the backward
    ships the dense cotangent through the plain wired collective (rows that
    were zero forward can carry nonzero cotangents)."""

    @staticmethod
    def forward(ctx, x, mesh, wire, capacity):
        ctx.mesh, ctx.wire = mesh, wire
        ctx.suspended = gas_ops.counting_suspended()
        return _sparse_ship(x, mesh, wire, capacity)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _wired_a2a(g, ctx.mesh, ctx.wire, 0.0, 0), None, None, None


def _sparse_all_to_all(x: torch.Tensor, mesh, wire: str, capacity: int):
    return _SparseAllToAll.apply(x, mesh, wire, capacity)


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` splits the work: a ``DataMesh`` of more than one
    rank (a 1-rank mesh takes the reference path, as in JAX). Any other
    kind of mesh raises: the graph dataflows shard over the 1-D ``data``
    axis only (the named-axis ``Mesh`` is the LM's)."""
    if mesh is None:
        return False
    if isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"mesh=Mesh{tuple(mesh.axis_names)}: a named-axis Mesh carries "
            f"the sharded LM (models/, train/step.py); the graph dataflows "
            f"shard over a repro_torch.launch.mesh.DataMesh (spawn(fn, n) or "
            f"make_data_mesh), the 1-D 'data' axis of ROADMAP Queue 1 row 2")
    if not isinstance(mesh, DataMesh):
        raise NotImplementedError(
            f"mesh={type(mesh).__name__}: the port shards over a "
            f"repro_torch.launch.mesh.DataMesh, the 1-D 'data' axis of "
            f"ROADMAP Queue 1 row 2; other meshes (a JAX Mesh, a 2-D data "
            f"x model mesh) are not ported")
    return mesh.shape["data"] > 1


def _resolve_scheduled(scheduled: Optional[bool], impl: str) -> bool:
    """The locality pass defaults on exactly where it pays: the kernel."""
    return (impl == "kernel") if scheduled is None else bool(scheduled)


def _permuted(sched: gas_ops.EdgeSchedule, *arrays: torch.Tensor):
    """Apply an edge schedule's permutation to per-edge arrays. Autograd
    transposes the index into the un-permuting scatter, so cotangents to
    weights (and values) return in the original edge order."""
    perm = sched.perm.long()
    return tuple(a[perm] for a in arrays)


def build_edge_schedule(dst_global: torch.Tensor, mask: torch.Tensor,
                        n_vertices: int, *, mesh=None) -> gas_ops.EdgeSchedule:
    """Destination-binned edge schedule over the caller's original-order
    (P, E) edge arrays, as in JAX: one schedule over the flattened edge
    list unsharded, this rank's own from its ``(1, E)`` slice on a sharded
    mesh. ``aggregate_edges(schedule=...)`` and ``edge_stream(schedule=...)``
    take it and apply its permutation once."""
    if not is_sharded(mesh):
        return _schedule(dst_global.reshape(-1), mask.reshape(-1),
                         n_vertices)
    return _schedule(dst_global[0], mask[0], n_vertices)


def _schedule(dst: torch.Tensor, mask: torch.Tensor,
              n_rows: int) -> gas_ops.EdgeSchedule:
    """``gas.schedule_edges`` inside the ``cgtrans.schedule`` span: every
    schedule the full-graph path builds."""
    with trace.span("cgtrans.schedule", dst):
        return gas.schedule_edges(dst, mask, n_rows)


# ---------------------------------------------------------------------------
# full-graph edge aggregation (GCN):  out[v] = ⊕_{(u,v,w)∈E} w · feats[u]
# ---------------------------------------------------------------------------

class EdgeStream(NamedTuple):
    """One rank's full-graph edge stream (``edge_stream``): per-edge table
    rows, destination rows in the ``n_rows`` = V space, weights and mask,
    in ``schedule`` order where one is set. ``scheduled`` is the resolved
    locality policy; the sharded baseline has no schedule here and bins
    after assembly when it is set."""
    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor
    n_rows: int
    schedule: Optional[gas_ops.EdgeSchedule]
    scheduled: bool
    mesh: object
    dataflow: str


def edge_stream(src_local, dst_global, weights, mask,
                table_shape: Tuple[int, int], *, mesh=None,
                dataflow: str = "cgtrans", impl: str = "ref",
                scheduled: Optional[bool] = None,   # None → impl="kernel"
                schedule: Optional[gas_ops.EdgeSchedule] = None
                ) -> EdgeStream:
    """The (P, E) edge arrays as ``partition_by_src`` lays them out, and
    the feature table's (P, part) → the stream every ``aggregate_stream``
    over them reads, built once per forward.

    Unsharded the partitions flatten into one V = P·part row space; on a
    sharded ``mesh`` the arrays are this rank's ``[rank:rank + 1]`` slices.
    Where ``scheduled`` resolves on, or ``schedule`` (``build_edge_schedule``
    over these arrays) is given, the stream is binned at the owner: the
    schedule built here unless given, its permutation applied here, once.
    The sharded baseline's row space exists only after assembly, so it
    bins there instead."""
    if dataflow not in ("cgtrans", "baseline"):
        raise ValueError(dataflow)
    check_impl(impl)
    Pn, part = table_shape
    use_sched = _resolve_scheduled(scheduled, impl) or schedule is not None
    sharded = is_sharded(mesh)
    if sharded and Pn != 1:
        raise ValueError(f"on a mesh feats is this rank's (1, part, F) "
                         f"slice, got (P, part) = {(Pn, part)}")
    V = (mesh.size if sharded else Pn) * part
    if not sharded:     # one row space: offset each partition's sources
        src_local = src_local + torch.arange(
            Pn, dtype=src_local.dtype, device=src_local.device)[:, None] * part
    s, d, w, m = (x.reshape(-1) for x in (src_local, dst_global, weights,
                                          mask))
    sched = None
    if use_sched and not (sharded and dataflow == "baseline"):
        sched = schedule if schedule is not None else _schedule(d, m, V)
        s, d, w, m = _permuted(sched, s, d, w, m)
    return EdgeStream(s, d, w, m, V, sched, use_sched, mesh, dataflow)


def _reads_table(table, stream: EdgeStream, op: gas.Op, impl: str,
                 sparse_cap: Optional[int]) -> bool:
    """Whether the kernel itself reads each edge's row from ``table``
    (``gas.gas_gather_scatter``): a scheduled add over a dense float32
    table on the kernel backend. Every other case gathers the rows first."""
    return (impl == "kernel" and op == "add" and sparse_cap is None
            and stream.schedule is not None and table.dtype == torch.float32)


def _agg_local(table, stream: EdgeStream, op: gas.Op, impl: str,
               sparse_cap: Optional[int] = None) -> torch.Tensor:
    """In-SSD step: local gather + segment-reduce into global dst bins, on
    the banded walk where the stream has a schedule; ``sparse_cap`` reads
    the table packed. A scheduled add of a dense f32 table on the kernel
    gathers nothing: the walk reads the rows from the table, and the find
    keeps its span (no device work), its tick and the ``gas.find.fused``
    count."""
    if _reads_table(table, stream, op, impl, sparse_cap):
        with trace.span("gas.find", table):
            gas._tick("find")
            entries.note("find", table)
            trace.add("gas.find.fused", 1)
        return gas.gas_gather_scatter(table, stream.src, stream.dst,
                                      stream.weights, stream.mask,
                                      stream.n_rows, schedule=stream.schedule)
    gathered = _find(table, stream.src, impl=impl, sparse_cap=sparse_cap)
    return gas.gas_scatter_weighted(stream.dst, gathered, stream.weights,
                                    stream.mask, stream.n_rows, op=op,
                                    impl=impl, schedule=stream.schedule)


def _edges_cgtrans(f, stream: EdgeStream, op, impl, wire, sparse_cap):
    """One rank's cgtrans body: aggregate at the owner, then ship each
    owner its interval's partials."""
    mesh = stream.mesh
    block = _agg_local(f, stream, op, impl, sparse_cap).reshape(
        mesh.size, *f.shape)
    if op == "add" and wire == "f32":
        return collectives.reduce_scatter(block, mesh)
    if op == "add":
        # quantized codes do not sum on the wire: ship each owner its
        # interval's encoded partials and accumulate in f32 here
        return _wire_all_to_all(block, mesh, wire).sum(0)
    # max / min / or: all_to_all + a local extremum (torch.amax / amin
    # split a cotangent evenly among ties, as JAX's max / min do); or-
    # partials are ≥ 0, so max realises the boolean or
    parts = (collectives.all_to_all(block, mesh) if wire == "f32" else
             _wire_all_to_all(block, mesh, wire, _wire_identity(op)))
    return torch.amin(parts, 0) if op == "min" else torch.amax(parts, 0)


def _edges_baseline(f, stream: EdgeStream, op, impl, sparse_cap):
    """One rank's baseline body: gather locally, all-gather the raw edge
    payload, its destinations and its mask, scatter the owned interval."""
    mesh = stream.mesh
    part, F = f.shape
    raw = _find(f, stream.src, impl=impl, sparse_cap=sparse_cap)
    # weights scale contributions under add only; max / min take the raw
    # feature and or ignores weights, as gas_scatter_weighted does
    if op == "add":
        raw = raw * stream.weights[:, None].to(raw.dtype)
    raw = torch.where(stream.mask[:, None], raw,
                      torch.zeros((), dtype=raw.dtype, device=raw.device))
    all_raw = collectives.all_gather(raw, mesh)            # (n, E, F)
    all_dst = collectives.all_gather(stream.dst, mesh)
    all_m = collectives.all_gather(stream.mask, mesh)
    # the destination side keeps its owned interval; the clip and the mask
    # come before the schedule, as in the reference
    rel = all_dst.reshape(-1) - mesh.rank * part
    ok = all_m.reshape(-1) & (rel >= 0) & (rel < part)
    vals = all_raw.reshape(-1, F)
    sched = None
    if stream.scheduled:
        # binned after assembly: the scatter's row space is this owner's
        # interval, which exists only after the all_gather
        sched = _schedule(rel, ok, part)
        rel, ok, vals = _permuted(sched, rel, ok, vals)
    return gas.gas_scatter_weighted(
        torch.clamp(rel, 0, part - 1).to(torch.int32), vals,
        torch.ones(rel.shape, dtype=torch.float32, device=rel.device), ok,
        part, op=op, impl=impl, schedule=sched)


def aggregate_stream(feats: torch.Tensor, stream: EdgeStream, *,
                     op: gas.Op = "add", impl: str = "ref",
                     wire: str = "f32", features: str = "dense",
                     sparse_capacity: Optional[int] = None) -> torch.Tensor:
    """One layer's aggregation over an ``edge_stream``: ``feats`` (P, part,
    F) owner-sharded, this rank's (1, part, F) on a sharded mesh → the
    aggregated destination features in the same layout; rows that no edge
    reaches hold the op identity (±inf for max / min). Unsharded, ``wire``
    is validated and otherwise a no-op. ``features="sparse"`` (with
    ``sparse_capacity``) reads the table packed, bit for bit dense."""
    with trace.span("cgtrans.aggregate", feats):
        check_impl(impl)
        _check_wire(wire, stream.dataflow, features)
        Pn, part, F = feats.shape
        sparse_cap = _resolve_sparse(features, sparse_capacity, F)
        if not is_sharded(stream.mesh):
            out = _agg_local(feats.reshape(Pn * part, F), stream, op, impl,
                             sparse_cap)
            return out.reshape(Pn, part, F)
        if stream.dataflow == "cgtrans":
            out = _edges_cgtrans(feats[0], stream, op, impl, wire, sparse_cap)
        else:
            out = _edges_baseline(feats[0], stream, op, impl, sparse_cap)
        return out[None]


def aggregate_edges(feats: torch.Tensor, src_local: torch.Tensor,
                    dst_global: torch.Tensor, weights: torch.Tensor,
                    mask: torch.Tensor, *, mesh=None,
                    dataflow: str = "cgtrans", op: gas.Op = "add",
                    impl: str = "ref", scheduled: Optional[bool] = None,
                    schedule: Optional[gas_ops.EdgeSchedule] = None,
                    wire: str = "f32", features: str = "dense",
                    sparse_capacity: Optional[int] = None) -> torch.Tensor:
    """(P, part, F) owner-sharded features and the (P, E) edge arrays of
    ``edge_stream`` → (P, part, F) aggregated destination features:
    ``aggregate_stream`` over a fresh stream (a caller that aggregates the
    same edges again keeps the stream). ``schedule`` is a
    ``build_edge_schedule`` result over these original-order arrays; the
    sharded baseline bins after assembly and ignores it. On a sharded
    ``mesh`` every argument and the result are this rank's slices."""
    stream = edge_stream(src_local, dst_global, weights, mask,
                         feats.shape[:2], mesh=mesh, dataflow=dataflow,
                         impl=impl, scheduled=scheduled, schedule=schedule)
    return aggregate_stream(feats, stream, op=op, impl=impl, wire=wire,
                            features=features,
                            sparse_capacity=sparse_capacity)


# ---------------------------------------------------------------------------
# sampled GraphSAGE aggregation: out[b] = reduce_k feats[nbrs[b, k]]
# ---------------------------------------------------------------------------

def _op_identity(dtype: torch.dtype, op: gas.Op):
    """The reduction identity a no-sample row must hold, per dtype (±inf on
    floats, the integer extremes on ints, 0 for add/or)."""
    if op in ("add", "or"):
        return 0
    if dtype.is_floating_point:
        return gas._INIT[op]
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _seed_reduce_rows(rows: torch.Tensor, own: torch.Tensor, op: gas.Op,
                      impl: str, scheduled: bool = False):
    """Per-segment GAS reduction on pre-gathered candidate rows:
    (R, K, F) rows + (R, K) validity → (R, F) partials + (R,) own counts.

    The seed index is the destination row, so the fan-out reduction is a
    FAST-GAS scatter. K=1 is a pure find: the scatter would be the identity
    permutation, so it masks the row with the op identity and launches no
    kernel.
    """
    R, K, F = rows.shape
    if K == 1:
        flat = rows.reshape(R, F)
        keep = own.reshape(R, 1)
        if op == "or":
            # mirror the scatter path's boolean-or normalisation: int-cast,
            # clamp the or-identity at 0
            red = torch.where(keep, torch.clamp(flat.to(torch.int32), min=0),
                              torch.zeros((), dtype=torch.int32,
                                          device=flat.device)).to(flat.dtype)
        else:
            red = torch.where(keep, flat,
                              torch.full((), _op_identity(flat.dtype, op),
                                         dtype=flat.dtype, device=flat.device))
        return red, own.sum(-1)
    seed = torch.arange(R, dtype=torch.int32,
                        device=rows.device).repeat_interleave(K)
    sched = (gas.schedule_edges(seed, own.reshape(-1), R, assume_sorted=True)
             if scheduled and impl == "kernel" else None)
    red = gas.gas_scatter_weighted(
        seed, rows.reshape(R * K, F),
        torch.ones(R * K, dtype=torch.float32, device=rows.device),
        own.reshape(-1), R, op=op, impl=impl, schedule=sched)
    return red, own.sum(-1)


def _mask_identity_rows(out: torch.Tensor, op: gas.Op) -> torch.Tensor:
    """Zero the ±inf max/min identity rows (seeds with no valid sample), at
    terminal positions only."""
    if op in ("max", "min"):
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out


def _finalize(red: torch.Tensor, cnt: torch.Tensor, op: gas.Op):
    """Partial → output rows: mean for add, identity-masked passthrough
    otherwise."""
    if op == "add":
        return red / torch.clamp(cnt, min=1).to(red.dtype)[..., None]
    return _mask_identity_rows(red, op)


def _combine_shards(parts: torch.Tensor, cnts: Optional[torch.Tensor],
                    op: gas.Op) -> torch.Tensor:
    """(n, B, F) per-source-shard partials (+ (n, B) counts) → (B, F)."""
    if op == "add":
        return parts.sum(0) / torch.clamp(cnts.sum(0), min=1).to(
            parts.dtype)[..., None]
    if op in ("max", "or"):
        return _mask_identity_rows(torch.amax(parts, 0), op)
    return _mask_identity_rows(torch.amin(parts, 0), op)


def _pad_rows(x: torch.Tensor, mult: int, fill) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def scan_request_chunks(body: Callable, nbrs2d: torch.Tensor,
                        mask2d: torch.Tensor, chunk: int) -> torch.Tensor:
    """Stream the (R, K) request block through ``body`` in row chunks.

    The SSD command-queue analogue: requests are issued ``chunk`` rows at a
    time; padded rows are all-masked, reduce to the op identity and are
    sliced off. Bit-exact with one full-block ``body`` call. A Python loop
    in place of the reference's ``lax.scan``: as a scan body is traced
    once, the loop body's dispatch and collective sites tick
    ``count_dispatches`` and ``count_collectives`` on the first chunk only
    (every chunk still launches its kernels and issues its collectives).
    """
    R = nbrs2d.shape[0]
    chunk = max(1, min(chunk, R))
    nb = _pad_rows(nbrs2d, chunk, 0)
    mk = _pad_rows(mask2d, chunk, False)
    outs = []
    for i, start in enumerate(range(0, nb.shape[0], chunk)):
        args = (nb[start:start + chunk], mk[start:start + chunk])
        if i == 0:
            outs.append(body(*args))
        else:
            with gas_ops.suspend_counting():
                outs.append(body(*args))
    return torch.cat(outs)[:R]


class SegmentDescriptor(NamedTuple):
    """Static layout of a coalesced request block (one "SSD command block").

    ``shapes``       — per-segment (rows_i, K_i);
    ``id_offsets``   — flat-id offset of each segment (length S+1);
    ``row_offsets``  — output-row offset of each segment (length S+1);
    ``tenants``      — per-segment owner tags (length S, or None): the
                       serving engine scatters each segment's rows back to
                       the caller that issued it and nobody else.
    """
    shapes: Tuple[Tuple[int, int], ...]
    id_offsets: Tuple[int, ...]
    row_offsets: Tuple[int, ...]
    tenants: Optional[Tuple[int, ...]] = None

    @property
    def n_ids(self) -> int:
        return self.id_offsets[-1]

    @property
    def n_rows(self) -> int:
        return self.row_offsets[-1]

    def segments_of(self, tenant: int) -> Tuple[int, ...]:
        """Indices of the segments owned by ``tenant`` (in block order)."""
        if self.tenants is None:
            raise ValueError("descriptor carries no tenant tags")
        return tuple(i for i, t in enumerate(self.tenants) if t == tenant)


def segment_descriptor(shapes: Sequence[Tuple[int, int]],
                       tenants: Optional[Sequence[int]] = None
                       ) -> SegmentDescriptor:
    """Build the descriptor for segments of static (rows_i, K_i) shapes."""
    shapes = tuple((int(r), int(k)) for r, k in shapes)
    if not shapes:
        raise ValueError("a request block needs at least one segment")
    if any(r < 1 or k < 1 for r, k in shapes):
        raise ValueError(f"degenerate segment in {shapes}")
    if tenants is not None:
        tenants = tuple(int(t) for t in tenants)
        if len(tenants) != len(shapes):
            raise ValueError(
                f"tenant tags ({len(tenants)}) must match segments "
                f"({len(shapes)})")
    ids, rows = [0], [0]
    for r, k in shapes:
        ids.append(ids[-1] + r * k)
        rows.append(rows[-1] + r)
    return SegmentDescriptor(shapes, tuple(ids), tuple(rows), tenants)


def _encode_requests(blocks) -> torch.Tensor:
    """Encode each (nbrs, mask) segment as one id stream with masked
    entries set to -1; returns the (P, N_tot) concatenated stream."""
    flat = [torch.where(m, nb, torch.full_like(nb, -1)).reshape(nb.shape[0], -1)
            for nb, m in blocks]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)


def _multi_find(table: torch.Tensor, seg_ids: List[torch.Tensor], op: gas.Op,
                impl: str, use_sched: bool, sparse_cap: Optional[int] = None):
    """ONE combined gather over every segment's encoded ids (-1 or out of
    range = dead; packed when ``sparse_cap`` is set), then the per-segment
    seed reductions. Returns a list of (red_i (R_i, F), cnt_i (R_i,))."""
    V, F = table.shape
    flat = (seg_ids[0].reshape(-1) if len(seg_ids) == 1 else
            torch.cat([s.reshape(-1) for s in seg_ids]))
    own = (flat >= 0) & (flat < V)
    rows = _find(table, torch.clamp(flat, 0, V - 1), impl=impl,
                 sparse_cap=sparse_cap)
    outs, off = [], 0
    for s in seg_ids:
        R, K = s.shape
        outs.append(_seed_reduce_rows(
            rows[off:off + R * K].reshape(R, K, F),
            own[off:off + R * K].reshape(R, K), op, impl, use_sched))
        off += R * K
    return outs


def _sharded_fetch(f: torch.Tensor, seg_enc: List[torch.Tensor], mesh,
                   dataflow: str, op: gas.Op, impl: str, use_sched: bool,
                   wire: str = "f32", sparse_cap: Optional[int] = None):
    """ONE command block over this rank's segments [(r_i, k_i) encoded
    ids] against its (part, F) rows → list of (r_i, F) aggregated rows
    for its own seeds (the JAX ``shard_map`` body's ``fetch``)."""
    n, part, F = mesh.size, f.shape[0], f.shape[1]
    shapes = [tuple(s.shape) for s in seg_enc]
    flat = (seg_enc[0].reshape(-1) if len(seg_enc) == 1 else
            torch.cat([s.reshape(-1) for s in seg_enc]))
    # the request broadcast: ONE all_gather of the concatenated id stream
    # (masks ride the -1 encoding); on a narrow wire as int16 deltas when
    # the vertex range fits
    if wire != "f32" and wirefmt.delta_ids_fit(n * part):
        ids = wirefmt.delta_decode_ids(collectives.all_gather(
            wirefmt.delta_encode_ids(flat), mesh))
    else:
        ids = collectives.all_gather(flat, mesh)          # (n, N)
    rel = ids - mesh.rank * part                          # dead ids stay < 0

    if dataflow == "cgtrans":
        offs = segment_descriptor(shapes).id_offsets
        seg_rel = [rel[:, offs[i]:offs[i + 1]].reshape(n * r, k)
                   for i, (r, k) in enumerate(shapes)]
        # in-SSD aggregation: ONE gather, per-segment reductions
        found = _multi_find(f, seg_rel, op, impl, use_sched, sparse_cap)
        reds = [red.reshape(n, r, F) for (red, _), (r, k) in zip(found, shapes)]
        payload = reds[0] if len(reds) == 1 else torch.cat(reds, dim=1)
        if op == "add":
            cnts = [cnt.reshape(n, r).to(f.dtype)
                    for (_, cnt), (r, k) in zip(found, shapes)]
            cnt = cnts[0] if len(cnts) == 1 else torch.cat(cnts, dim=1)
            # the counts ride the payload as one extra feature column
            payload = torch.cat([payload, cnt[..., None]], dim=-1)
        # on a narrow wire the count column rides exactly
        parts = (collectives.all_to_all(payload, mesh) if wire == "f32" else
                 _wire_all_to_all(payload, mesh, wire, _wire_identity(op),
                                  1 if op == "add" else 0))
        outs, roff = [], 0
        for r, k in shapes:
            seg = parts[:, roff:roff + r]
            roff += r
            outs.append(_combine_shards(seg[..., :F], seg[..., F], op)
                        if op == "add" else _combine_shards(seg, None, op))
        return outs

    # baseline: gather once, ship the raw (n, N, F) rows plus the ownership
    # bits (bool, as JAX ships them; ``collectives`` sends their bytes) to
    # the seed owners, reduce there
    own = (rel >= 0) & (rel < part)
    rows = _find(f, torch.clamp(rel, 0, part - 1).reshape(-1), impl=impl,
                 sparse_cap=sparse_cap).reshape(n, -1, F)
    rows = torch.where(own[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    if sparse_cap is not None and rows.element_size() == 4:
        # the raw shipment, packed: non-owned rows were just zeroed and
        # owned rows fit the table's capacity (a sub-32-bit table keeps the
        # dense ship: its lanes cannot carry an int32 bitmap word)
        raw = _sparse_all_to_all(rows, mesh, wire, sparse_cap)
    else:
        raw = collectives.all_to_all(rows, mesh)          # (n, N, F)
    okk = collectives.all_to_all(own[..., None], mesh)[..., 0]
    outs, off = [], 0
    for r, k in shapes:
        sl = slice(off, off + r * k)
        off += r * k
        # every source shard's k candidates line up per seed row: (r, n·k)
        seg_rows = raw[:, sl].reshape(n, r, k, F).permute(1, 0, 2, 3).reshape(
            r, n * k, F)
        seg_ok = okk[:, sl].reshape(n, r, k).permute(1, 0, 2).reshape(
            r, n * k)
        red, cnt = _seed_reduce_rows(seg_rows, seg_ok, op, impl, use_sched)
        outs.append(_finalize(red, cnt, op))
    return outs


def aggregate_multi(
    feats: torch.Tensor,  # (P, part, F) owner-sharded features
    blocks,               # sequence of (nbrs (P, R_i, K_i), mask) segments
    *,
    mesh=None,
    dataflow: str = "cgtrans",
    op: gas.Op = "add",
    impl: str = "ref",
    request_chunk: Optional[int] = None,
    scheduled: Optional[bool] = None,   # None → on for impl="kernel"
    wire: str = "f32",
    features: str = "dense",
    sparse_capacity: Optional[int] = None,
):
    """Coalesced request blocks: aggregate several sampled request segments
    in ONE command block. Returns a tuple of (P, R_i, F), one per segment,
    each what ``aggregate_sampled`` returns for that segment alone.

    ``op="add"`` is the masked mean; max/min/or reduce elementwise over the
    valid samples; seeds with no valid sample read 0 on every op. The
    tensors' device is where the work runs. On a sharded ``mesh`` the
    arguments and the result are this rank's slices (P = 1 locally: its
    ``(1, part, F)`` rows, its ``(1, R_i, K_i)`` requests); the two
    dataflows differ only there. ``wire`` compresses both collectives
    (int16 delta ids when ``delta_ids_fit(V)``, bf16 or int8 partials with
    the count column exact); ``features="sparse"`` reads the table packed
    and, on the baseline, ships the raw rows packed. Both are validated
    no-ops without a mesh, and sparse is bit for bit dense.
    """
    if dataflow not in ("cgtrans", "baseline"):
        raise ValueError(dataflow)
    check_impl(impl)
    _check_wire(wire, dataflow, features)
    sharded = is_sharded(mesh)
    blocks = tuple(blocks)
    Pn, part, F = feats.shape
    sparse_cap = _resolve_sparse(features, sparse_capacity, F)
    if sharded and Pn != 1:
        raise ValueError(f"on a mesh feats is this rank's (1, part, F) "
                         f"slice, got {tuple(feats.shape)}")
    desc = segment_descriptor([tuple(nb.shape[-2:]) for nb, _ in blocks])
    use_sched = _resolve_scheduled(scheduled, impl)
    enc = _encode_requests(blocks)                       # (P, N_tot)
    seg_enc = [enc[:, desc.id_offsets[i]:desc.id_offsets[i + 1]].reshape(-1, k)
               for i, (r, k) in enumerate(desc.shapes)]  # (Pn·R_i, K_i)
    table = feats.reshape(Pn * part, F)

    if sharded:
        def fetch(segs):
            return _sharded_fetch(table, segs, mesh, dataflow, op, impl,
                                  use_sched, wire, sparse_cap)
    else:
        def fetch(segs):
            return [_finalize(red, cnt, op)
                    for red, cnt in _multi_find(table, segs, op, impl,
                                                use_sched, sparse_cap)]

    if request_chunk is None:
        outs = fetch(seg_enc)
    else:
        # the chunked command queue respects segment boundaries: each
        # segment streams separately (their K differ)
        def one(nb_c, m_c):
            return fetch([torch.where(m_c, nb_c, torch.full_like(nb_c, -1))
                          ])[0]

        outs = [scan_request_chunks(one, e, e >= 0, request_chunk)
                for e in seg_enc]
    return tuple(o.reshape(Pn, r, F) for o, (r, k) in zip(outs, desc.shapes))


def aggregate_sampled(
    feats: torch.Tensor,  # (P, part, F) owner-sharded features
    nbrs: torch.Tensor,   # (P, B_loc, K) global neighbor ids
    mask: torch.Tensor,   # (P, B_loc, K)
    *,
    mesh=None,
    dataflow: str = "cgtrans",
    op: gas.Op = "add",
    impl: str = "ref",
    request_chunk: Optional[int] = None,
    scheduled: Optional[bool] = None,
    wire: str = "f32",
    features: str = "dense",
    sparse_capacity: Optional[int] = None,
) -> torch.Tensor:
    """Returns (P, B_loc, F) aggregated neighbor features per seed — the
    single-segment form of ``aggregate_multi``."""
    out, = aggregate_multi(feats, ((nbrs, mask),), mesh=mesh,
                           dataflow=dataflow, op=op, impl=impl,
                           request_chunk=request_chunk, scheduled=scheduled,
                           wire=wire, features=features,
                           sparse_capacity=sparse_capacity)
    return out
