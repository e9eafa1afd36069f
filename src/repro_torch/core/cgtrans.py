"""CGTrans sampled aggregation — unsharded and over a ``data`` mesh
(paper §3.2).

Vertex features live owner-sharded on the storage tier, laid out as
``(P, part, F)``; requests carry ids only. ``aggregate_multi`` fuses several
request segments of different fan-out (e.g. ``sage_forward``'s K=1
self-row lookup and its 2-hop block) into ONE command block — one combined
gather (``_multi_find``), then a per-segment seed reduction: a K=1 segment
is a pure find with no kernel, a K>1 segment is one FAST-GAS scatter, on
the banded walk when ``scheduled`` (the seed stream ``repeat(arange(R), K)``
is destination-binned by construction, so its schedule needs no sort).

On a ``repro_torch.launch.mesh.DataMesh`` of P > 1 ranks each rank runs the
JAX package's ``shard_map`` body on its own slice — ``feats`` is the rank's
``(1, part, F)`` rows, each block the rank's ``(1, R_i, K_i)`` requests,
the result the rank's ``(1, R_i, F)`` — through the collectives of
``repro_torch.core.collectives``, in the reference's shape:

* ``cgtrans``: ONE ``all_gather`` of the concatenated ``-1``-encoded id
  stream, ONE ``_multi_find`` against the local rows (ids outside
  ``[0, part)`` are dead), ONE ``all_to_all`` of the (n, R_tot, F) partials
  with the add counts as one extra column, combined per seed on arrival;
* ``baseline``: the same broadcast, then the raw gathered rows'
  ``all_to_all`` plus the ownership bits' ``all_to_all``, reduced at the
  seed's owner.

``request_chunk`` streams each segment through the command block that many
rows at a time; chunking partitions rows, never a row's K entries, so the
result is bit-exact with the unchunked block.

Not in this module yet (each raises ``NotImplementedError`` naming its
ROADMAP row): compressed wires (``wire`` other than ``"f32"``) and
compressed-sparse features (``features="sparse"``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives, gas
from repro_torch.device import check_impl
from repro_torch.kernels.gas_scatter import ops as gas_ops
from repro_torch.launch.mesh import DataMesh

WIRE_FORMATS = ("f32", "bf16", "int8")


def _check_wire(wire: str, dataflow: str, features: str = "dense") -> str:
    """Validate a ``wire=`` knob as the JAX package does. Without a mesh the
    wire carries nothing, so only ``"f32"`` runs; the compressed codecs
    raise until they are ported."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; expected one of "
                         f"{WIRE_FORMATS}")
    if wire != "f32" and dataflow == "baseline" and features != "sparse":
        raise ValueError(
            "wire compression is a cgtrans-dataflow mechanism; the baseline "
            "strawman ships raw f32 by definition (features='sparse' is the "
            "exception: packed nonzeros quantize like partials)")
    if wire != "f32":
        raise NotImplementedError(
            f"wire={wire!r}: the compressed wire formats are not ported yet "
            f"(ROADMAP Queue 1, core/wire.py)")
    return wire


def _check_features(features: str, sparse_capacity: Optional[int]) -> None:
    if features not in ("dense", "sparse"):
        raise ValueError(f"unknown features {features!r}")
    if features == "sparse":
        raise NotImplementedError(
            "features='sparse' is not ported yet (ROADMAP Queue 1, "
            "core/sparse.py)")
    if sparse_capacity is not None:
        raise ValueError("sparse_capacity= only applies with "
                         "features='sparse'")


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` splits the work: a ``DataMesh`` of more than one
    rank (a 1-rank mesh takes the reference path, as in JAX). Any other
    kind of mesh raises: the port shards over the 1-D ``data`` axis only."""
    if mesh is None:
        return False
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
                impl: str, use_sched: bool):
    """ONE combined gather over every segment's encoded ids (-1 or out of
    range = dead), then the per-segment seed reductions. Returns a list of
    (red_i (R_i, F), cnt_i (R_i,))."""
    V, F = table.shape
    flat = (seg_ids[0].reshape(-1) if len(seg_ids) == 1 else
            torch.cat([s.reshape(-1) for s in seg_ids]))
    own = (flat >= 0) & (flat < V)
    rows = gas.gas_gather(table, torch.clamp(flat, 0, V - 1), impl=impl)
    outs, off = [], 0
    for s in seg_ids:
        R, K = s.shape
        outs.append(_seed_reduce_rows(
            rows[off:off + R * K].reshape(R, K, F),
            own[off:off + R * K].reshape(R, K), op, impl, use_sched))
        off += R * K
    return outs


def _sharded_fetch(f: torch.Tensor, seg_enc: List[torch.Tensor], mesh,
                   dataflow: str, op: gas.Op, impl: str, use_sched: bool):
    """ONE command block over this rank's segments [(r_i, k_i) encoded
    ids] against its (part, F) rows → list of (r_i, F) aggregated rows
    for its own seeds (the JAX ``shard_map`` body's ``fetch``)."""
    n, part, F = mesh.size, f.shape[0], f.shape[1]
    shapes = [tuple(s.shape) for s in seg_enc]
    flat = (seg_enc[0].reshape(-1) if len(seg_enc) == 1 else
            torch.cat([s.reshape(-1) for s in seg_enc]))
    # the request broadcast: ONE all_gather of the concatenated id stream
    # (masks ride the -1 encoding)
    ids = collectives.all_gather(flat, mesh)              # (n, N)
    rel = ids - mesh.rank * part                          # dead ids stay < 0

    if dataflow == "cgtrans":
        offs = segment_descriptor(shapes).id_offsets
        seg_rel = [rel[:, offs[i]:offs[i + 1]].reshape(n * r, k)
                   for i, (r, k) in enumerate(shapes)]
        # in-SSD aggregation: ONE gather, per-segment reductions
        found = _multi_find(f, seg_rel, op, impl, use_sched)
        reds = [red.reshape(n, r, F) for (red, _), (r, k) in zip(found, shapes)]
        payload = reds[0] if len(reds) == 1 else torch.cat(reds, dim=1)
        if op == "add":
            cnts = [cnt.reshape(n, r).to(f.dtype)
                    for (_, cnt), (r, k) in zip(found, shapes)]
            cnt = cnts[0] if len(cnts) == 1 else torch.cat(cnts, dim=1)
            # the counts ride the payload as one extra feature column
            payload = torch.cat([payload, cnt[..., None]], dim=-1)
        parts = collectives.all_to_all(payload, mesh)     # (n, R_tot, F(+1))
        outs, roff = [], 0
        for r, k in shapes:
            seg = parts[:, roff:roff + r]
            roff += r
            outs.append(_combine_shards(seg[..., :F], seg[..., F], op)
                        if op == "add" else _combine_shards(seg, None, op))
        return outs

    # baseline: gather once, ship the raw (n, N, F) rows plus the ownership
    # bits (as bytes: NCCL has no bool) to the seed owners, reduce there
    own = (rel >= 0) & (rel < part)
    rows = gas.gas_gather(f, torch.clamp(rel, 0, part - 1).reshape(-1),
                          impl=impl).reshape(n, -1, F)
    rows = torch.where(own[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    raw = collectives.all_to_all(rows, mesh)              # (n, N, F)
    okk = collectives.all_to_all(own.to(torch.uint8)[..., None],
                                 mesh)[..., 0].bool()
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
    dataflows differ only there.
    """
    if dataflow not in ("cgtrans", "baseline"):
        raise ValueError(dataflow)
    check_impl(impl)
    _check_wire(wire, dataflow, features)
    _check_features(features, sparse_capacity)
    sharded = is_sharded(mesh)
    blocks = tuple(blocks)
    Pn, part, F = feats.shape
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
                                  use_sched)
    else:
        def fetch(segs):
            return [_finalize(red, cnt, op)
                    for red, cnt in _multi_find(table, segs, op, impl,
                                                use_sched)]

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
