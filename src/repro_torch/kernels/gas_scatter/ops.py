"""Public wrappers for the FAST-GAS scatter kernels.

Three layers, as in the JAX package's module of the same name:

* ``schedule_edges`` — the locality pass (paper Fig 11(c)): a stable sort
  of the edge stream by destination row block, compiled into the banded
  kernel's work list, so each row block visits only its own edge tiles.
* ``row_sorted_index`` — the unscheduled dense grid's index: a stable
  sort of the edge stream by row, each row block's start found on the
  device. (``occupancy_map``, the JAX package's exact (row block × edge
  tile) bitmap, stays for accounting: ``dense_skip_stats``.)
* ``gas_scatter`` / ``gas_scatter_fused`` — padding + dispatch. The fused
  entry takes mask and edge weights into the kernel (mask via the dead-row
  convention: a dead edge's dst is the padded row count, so it matches no
  row; weights scale each edge's contribution), so no ``values * weights``
  or mask-filled E×F stream is staged. With ``src`` a scheduled add takes
  the feature table itself and the banded walk reads each edge's row from
  it, so no gathered E×F stream is built either.

``fused_call`` exposes the exact kernel call a fused dispatch makes, so a
caller can hold the kernel against its plain version on the same inputs.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import entries
from repro_torch.kernels.gas_scatter import kernel as K
from repro_torch.kernels.gas_scatter.ref import gas_scatter_ref
from repro_torch.runtime import trace

ROW_BLOCK = K.ROW_BLOCK
EDGE_TILE = K.EDGE_TILE
FEAT_BLOCK = K.FEAT_BLOCK

# ---------------------------------------------------------------------------
# dispatch counting (the deterministic "how many kernel calls" view)
# ---------------------------------------------------------------------------

_DISPATCH_COUNTS: Optional[Counter] = None
_SUSPENDED = False


@contextlib.contextmanager
def count_dispatches():
    """Count GAS dispatch sites while the context is active.

    Keys: ``kernel_scatter`` (one per public kernel-scatter call, ticked
    here), ``find`` and ``reduce`` (ticked by ``repro_torch.core.gas``). The
    counts mirror the call sites of the JAX package's traced program: a
    call site counts once per program, and a chunk loop counts its body
    once, as a scan body appears once in the reference
    (``suspend_counting``). A backward rule ticks where its forward did
    and stays silent where its forward was suspended. Contexts nest: the
    innermost counter receives the ticks.
    """
    global _DISPATCH_COUNTS, _SUSPENDED
    prev = _DISPATCH_COUNTS, _SUSPENDED
    _DISPATCH_COUNTS, _SUSPENDED = Counter(), False
    try:
        yield _DISPATCH_COUNTS
    finally:
        _DISPATCH_COUNTS, _SUSPENDED = prev


@contextlib.contextmanager
def suspend_counting(suspend: bool = True):
    """Run a block without ticking — for the second and later passes of a
    loop body whose dispatch sites were already counted once, and for the
    backward of such a pass. ``suspend=False`` leaves counting as it is."""
    global _SUSPENDED
    prev = _SUSPENDED
    _SUSPENDED = prev or suspend
    try:
        yield
    finally:
        _SUSPENDED = prev


def counting_suspended() -> bool:
    """Whether ticks are dropped here (inside ``suspend_counting``); a
    backward rule records it at forward time."""
    return _SUSPENDED


def _tick(kind: str) -> None:
    if _DISPATCH_COUNTS is not None and not _SUSPENDED:
        _DISPATCH_COUNTS[kind] += 1


def _pad_to(x: torch.Tensor, mult: int, axis: int, fill) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _padded_values(values: torch.Tensor, edges: bool = True) -> torch.Tensor:
    """The (E, F) value stream as the kernels consume it: edges padded to
    a multiple of ``EDGE_TILE`` (a feature table's rows, ``edges=False``,
    as they are), features to ``FEAT_BLOCK``, contiguous.
    Each copy made counts the bytes it reads plus writes into
    ``gas.pad.bytes`` (0 where the values are used as they are)."""
    out, moved = values, 0
    axes = ((EDGE_TILE, 0), (FEAT_BLOCK, 1)) if edges else ((FEAT_BLOCK, 1),)
    for mult, axis in axes:
        padded = _pad_to(out, mult, axis, 0.0)
        if padded is not out:
            moved += (out.numel() + padded.numel()) * out.element_size()
        out = padded
    if not out.is_contiguous():
        moved += 2 * out.numel() * out.element_size()
        out = out.contiguous()
    trace.add("gas.pad.bytes", moved)
    return out


def _padded_rows(n_rows: int) -> int:
    return -(-n_rows // ROW_BLOCK) * ROW_BLOCK


def _live(dst: torch.Tensor, mask: Optional[torch.Tensor],
          n_rows: int) -> torch.Tensor:
    """The dead-edge rule: an edge is live when unmasked and its
    destination lies in ``[0, n_rows)``."""
    ok = (dst >= 0) & (dst < n_rows)
    return ok if mask is None else ok & mask


def _dead_routed(dst: torch.Tensor, mask: Optional[torch.Tensor],
                 n_rows: int, R: int):
    """(ok, dst with every masked / out-of-range edge sent to row R)."""
    ok = _live(dst, mask, n_rows)
    return ok, torch.where(ok, dst, torch.full_like(dst, R)).to(torch.int32)


# ---------------------------------------------------------------------------
# the edge schedule: destination-binned order + banded idle-skip bounds
# ---------------------------------------------------------------------------

class EdgeSchedule(NamedTuple):
    """Destination-binned edge schedule for one (partition, batch).

    ``perm`` reorders the edge stream so destinations ascend by row block
    (stable within a block); dead edges sort to the end. ``blk_min`` /
    ``blk_max`` are the per-edge-tile live row-block bounds of the permuted,
    tile-padded stream (``blk_max < blk_min`` marks an all-dead tile).
    ``work`` compiles them into the banded kernel's walk order: (W, 4) rows
    [row_block, tile, live, init], W = T + 2·row_blocks, covering every live
    (row block, tile) pair once plus one init-only row per empty block.
    """
    perm: torch.Tensor      # (E,) int32
    blk_min: torch.Tensor   # (T,) int32
    blk_max: torch.Tensor   # (T,) int32; -1 on all-dead tiles
    work: torch.Tensor      # (W, 4) int32 [row_block, tile, live, init]


def _edge_bins(dst: torch.Tensor, mask: Optional[torch.Tensor], n_rows: int):
    """Row-block bin per edge; dead edges get the one-past-the-end bin."""
    n_blocks = -(-n_rows // ROW_BLOCK)
    bins = torch.where(_live(dst, mask, n_rows),
                       torch.div(dst, ROW_BLOCK, rounding_mode="floor"),
                       torch.full_like(dst, n_blocks))
    return bins.to(torch.int32), n_blocks


def _tile_bounds(bins: torch.Tensor, n_blocks: int):
    """Per-tile (min, max) live block of a (padded) bin stream."""
    t = _pad_to(bins, EDGE_TILE, 0, n_blocks).reshape(-1, EDGE_TILE)
    live = t < n_blocks
    blk_min = torch.where(live, t, torch.full_like(t, n_blocks)).amin(1)
    blk_max = torch.where(live, t, torch.full_like(t, -1)).amax(1)
    return blk_min.to(torch.int32), blk_max.to(torch.int32)


def _work_list(blk_min: torch.Tensor, blk_max: torch.Tensor,
               n_blocks: int) -> torch.Tensor:
    """Compile per-tile band bounds into the banded kernel's walk order.

    Returns (W, 4) int32 rows [row_block, tile, live, init] ordered by row
    block, where each row block's run is its own contiguous tile range and
    starts at its init row. W = T + 2·n_blocks is a static bound; trailing
    rows are dead filler pinned to the last block.
    """
    dev = blk_min.device
    T = blk_min.shape[0]
    W = T + 2 * n_blocks
    lo, hi = blk_min.long(), blk_max.long()
    dead = hi < 0
    # monotone envelopes: interior all-dead tiles inherit neighbour bounds,
    # restoring the ascending order searchsorted needs
    hi_env = torch.cummax(torch.where(dead, torch.full_like(hi, -1), hi),
                          0).values
    lo_env = torch.cummin(
        torch.where(dead, torch.full_like(lo, n_blocks), lo).flip(0),
        0).values.flip(0)
    r = torch.arange(n_blocks, device=dev)
    t_lo = torch.searchsorted(hi_env, r)                 # first tile ∋ r
    t_hi = torch.maximum(torch.searchsorted(lo_env, r, right=True), t_lo)
    cnt = torch.clamp(t_hi - t_lo, min=1)                # empty block: init
    offs = torch.cat([torch.zeros(1, dtype=cnt.dtype, device=dev),
                      torch.cumsum(cnt, 0)])
    w = torch.arange(W, device=dev)
    rb = torch.searchsorted(offs[1:].contiguous(), w, right=True)
    rb_c = torch.clamp(rb, max=n_blocks - 1)
    j = w - offs[rb_c]
    tile = torch.clamp(t_lo[rb_c] + j, 0, T - 1)
    live = (rb < n_blocks) & (j < (t_hi - t_lo)[rb_c])
    init = (rb < n_blocks) & (j == 0)
    return torch.stack([rb_c, tile, live.long(), init.long()],
                       dim=1).to(torch.int32)


def schedule_edges(dst: torch.Tensor, mask: Optional[torch.Tensor],
                   n_rows: int, *,
                   assume_sorted: bool = False) -> EdgeSchedule:
    """Bin the edge stream by destination row block (stable sort).

    ``dst``: (E,) destination rows in ``[0, n_rows)``; masked or
    out-of-range entries are dead and sort last. ``assume_sorted=True``
    skips the sort (``perm`` is the identity) for streams binned by
    construction, e.g. the sampled path's ``repeat(arange(R), K)`` seeds.
    """
    bins, n_blocks = _edge_bins(dst, mask, n_rows)
    iota = torch.arange(dst.shape[0], dtype=torch.int32, device=dst.device)
    if assume_sorted:
        sorted_bins, perm = bins, iota
    else:
        sorted_bins, perm = torch.sort(bins, stable=True)
        perm = perm.to(torch.int32)
    blk_min, blk_max = _tile_bounds(sorted_bins, n_blocks)
    return EdgeSchedule(perm, blk_min, blk_max,
                        _work_list(blk_min, blk_max, n_blocks))


def schedule_skip_stats(sched: EdgeSchedule):
    """(live_rounds, total_rounds) of a schedule: the (row block × edge
    tile) rounds the banded walk executes vs the dense grid."""
    n_blocks = int(sched.work[:, 0].max()) + 1
    total = n_blocks * sched.blk_min.shape[0]
    return int(sched.work[:, 2].sum()), total


def dense_skip_stats(dst: torch.Tensor, mask: Optional[torch.Tensor],
                     n_rows: int):
    """(live_rounds, total_rounds) of the unscheduled occupancy grid for
    the same edge stream, as the JAX package's ``gas_scatter_fused``
    dispatches it: the (row block × edge tile) pairs its occupancy map
    sets, of all of them. Accounting only: the port's dense kernel walks a
    row-sorted index (``row_sorted_index``) and visits each edge once."""
    R = _padded_rows(n_rows)
    _, routed = _dead_routed(dst, mask, n_rows, R)
    occ = occupancy_map(_pad_to(routed, EDGE_TILE, 0, R), R // ROW_BLOCK)
    return int(occ.sum()), int(occ.numel())


def feat_skip_stats(schedule: EdgeSchedule, values: torch.Tensor):
    """(live_rounds, band_rounds) of a scheduled add dispatch over these
    ``values`` (E, F): the (row block × edge tile × feature block) rounds
    the feature-skipping banded walk executes against the band's live rounds
    times the feature blocks. Counted, not clocked. The port's feature
    block is 32 wide, where the JAX package's interpret-mode kernel runs one
    block over the whole width: the counts equal the JAX package's where
    F ≤ 32 and follow the port's 32-feature blocks at wider F."""
    valp = _pad_to(_pad_to(values, EDGE_TILE, 0, 0), FEAT_BLOCK, 1, 0)
    feat = K.tile_feature_liveness(valp)[schedule.work[:, 1].long()]
    live = schedule.work[:, 2] == 1
    return (int((feat & live[:, None]).sum()),
            int(live.sum()) * feat.shape[1])


def row_sorted_index(dst: torch.Tensor, n_row_blocks: int):
    """(ids, order, starts): the dense kernel's index of a routed,
    tile-padded edge stream ``dst`` (E,) int32, dead edges at the padded
    row count R = 128 · ``n_row_blocks``. ``ids`` is ``dst`` sorted by a
    stable sort (each row keeps its edges in stream order; dead edges sort
    last), ``order`` (E,) int32 the edge at each sorted position, and
    ``starts`` (n_row_blocks + 1,) int32 each row block's first position
    (``starts[-1]``: the live edges). Built on the device from shapes
    alone; nothing is read back to the host.

    Counts into ``gas.dense.index.bytes`` the bytes its steps read and
    write, each input read once and each output written once: the sort
    (E int32 keys in; E keys and E int64 positions out), the positions'
    cast to int32, the row blocks' bounds (written, then read) and
    ``starts``: 28·E + 12·(n_row_blocks + 1)."""
    E = dst.shape[0]
    ids, order = torch.sort(dst, stable=True)
    bounds = torch.arange(0, (n_row_blocks + 1) * ROW_BLOCK, ROW_BLOCK,
                          dtype=torch.int32, device=dst.device)
    starts = torch.searchsorted(ids, bounds, out_int32=True)
    trace.add("gas.dense.index.bytes", 28 * E + 12 * (n_row_blocks + 1))
    return ids, order.to(torch.int32), starts


def occupancy_map(dst: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """(row_blocks, edge_tiles) int32: does edge tile e touch row block r?
    One bincount over (block, tile) pairs: O(E + R·T)."""
    E = dst.shape[0]
    T = E // EDGE_TILE
    blk = torch.div(dst.long(), ROW_BLOCK, rounding_mode="floor")
    dead = (blk < 0) | (blk >= n_row_blocks)
    idx = torch.where(dead, torch.full_like(blk, n_row_blocks), blk)
    flat = idx * T + torch.arange(E, device=dst.device) // EDGE_TILE
    counts = torch.bincount(flat, minlength=(n_row_blocks + 1) * T)
    return (counts[: n_row_blocks * T].reshape(n_row_blocks, T) > 0
            ).to(torch.int32)


# ---------------------------------------------------------------------------
# dispatch wrappers
# ---------------------------------------------------------------------------

class KernelCall(NamedTuple):
    """One kernel launch: ``kernel`` names the wrapper in ``kernel.py`` and
    ``args`` / ``kwargs`` are what it receives."""
    kernel: str
    args: tuple
    kwargs: dict

    def run(self) -> torch.Tensor:
        with trace.span("gas.kernel", self.args[0]):
            return getattr(K, self.kernel)(*self.args, **self.kwargs)

    def run_plain(self) -> torch.Tensor:
        return getattr(K, self.kernel + "_plain")(*self.args, **self.kwargs)


def gas_scatter(dst: torch.Tensor, values: torch.Tensor, n_rows: int, *,
                op: str = "add") -> torch.Tensor:
    """Scatter-reduce ``values`` (E,) or (E, F) into (n_rows[, F]) by
    ``dst`` (E,) through the dense-grid kernel. Matches
    ``ref.gas_scatter_ref`` exactly (out-of-range dst ignored). One public
    call = one kernel dispatch, ticked into ``count_dispatches``."""
    entries.refuse_fake("gas_scatter", values, dst)
    with trace.span("gas.scatter", values):
        _tick("kernel_scatter")
        entries.note("kernel_scatter", values)
        return _gas_scatter(dst, values, n_rows, op=op)


def _gas_scatter(dst, values, n_rows: int, *, op: str):
    if op == "or":
        # boolean-or over {0,1} = max with an or-identity of 0 for empty
        # rows; the dtype rewrite happens once, before the ndim dispatch
        out = _gas_scatter(dst, values.to(torch.float32), n_rows, op="max")
        return torch.clamp(out, min=0).to(values.dtype)
    if values.dim() == 1:
        return _gas_scatter(dst, values[:, None], n_rows, op=op)[:, 0]
    call = fused_call(dst, values, None, None, n_rows, op=op)
    return call.run()[:n_rows, :values.shape[1]]


def fused_call(dst: torch.Tensor, values: torch.Tensor,
               weights: Optional[torch.Tensor], mask: Optional[torch.Tensor],
               n_rows: int, *, op: str = "add",
               schedule: Optional[EdgeSchedule] = None,
               src: Optional[torch.Tensor] = None) -> KernelCall:
    """The kernel call ``gas_scatter_fused`` makes for 2-D ``values``: the
    padded edge stream (dead edges at the padded row count R, tiles of 128
    edges, features a multiple of 32) and either the work list (scheduled)
    or the row-sorted index (unscheduled, ``row_sorted_index``). Its
    result is (R, F padded).

    With ``src`` (E,) the stream's rows are ``values[src]``: ``values`` is
    the (V, F) float32 table, padded to 32 features once, ``src`` is padded
    to the edge tile with -1 (a zero row), and the scheduled add launches
    the banded walk's gathered instantiation over them."""
    if op not in ("add", "max", "min"):
        raise ValueError(op)
    if src is not None and (schedule is None or op != "add"):
        raise ValueError("a table with src= takes the scheduled add's "
                         "gathered walk: pass its schedule and op='add'")
    R = _padded_rows(n_rows)
    n_blocks = R // ROW_BLOCK
    with trace.span("gas.pad", values):
        _, routed = _dead_routed(dst, mask, n_rows, R)
        dstp = _pad_to(routed, EDGE_TILE, 0, R)
        if src is None:
            valp = _padded_values(values)
        else:
            valp = _padded_values(values, edges=False)
            srcp = _pad_to(src.to(torch.int32), EDGE_TILE, 0,
                           -1).contiguous()
        wp = None
        if op == "add" and weights is not None:
            wp = _pad_to(weights.to(torch.float32), EDGE_TILE, 0,
                         0.0).contiguous()
    if schedule is None:
        return KernelCall("gas_scatter_dense",
                          (*row_sorted_index(dstp, n_blocks), valp, R),
                          {"op": op, "weights": wp})
    T = dstp.shape[0] // EDGE_TILE
    if schedule.blk_min.shape[0] != T:
        raise ValueError(
            f"schedule has {schedule.blk_min.shape[0]} tile bounds but the "
            f"padded edge stream has {T} tiles — was the schedule built for "
            f"a different edge count or tile size?")
    if schedule.work.shape[0] != T + 2 * n_blocks:
        raise ValueError(
            f"schedule work list sized for a different row space: "
            f"{schedule.work.shape[0]} != {T} + 2·{n_blocks}")
    if op == "add":
        # the kernel skips all-zero feature blocks, deciding from the value
        # rows it stages: no value byte is read for it out here
        trace.add("gas.liveness.bytes", 0)
    if src is not None:
        return KernelCall("gas_scatter_banded_gathered",
                          (schedule.work.contiguous(), dstp, srcp, valp, R),
                          {"op": op, "weights": wp})
    return KernelCall("gas_scatter_banded",
                      (schedule.work.contiguous(), dstp, valp, R),
                      {"op": op, "weights": wp})


def gas_scatter_fused(dst: torch.Tensor, values: torch.Tensor,
                      weights: Optional[torch.Tensor],
                      mask: Optional[torch.Tensor], n_rows: int, *,
                      op: str = "add",
                      schedule: Optional[EdgeSchedule] = None,
                      src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked, weighted scatter-reduce in one kernel dispatch.

    The mask folds into the dead-row convention and, for ``op="add"``, the
    weights ride into the kernel; compare ops ignore ``weights``. ``values``
    at masked positions must be finite (they are never matched, not
    replaced). ``schedule`` (an ``EdgeSchedule`` whose ``perm`` order the
    inputs are already in) swaps the dense grid for the banded walk.
    ``src`` (scheduled add only) makes ``values`` the (V, F) float32
    table whose rows ``values[src]`` are the stream, read by the kernel
    (``fused_call``). One public call = one kernel dispatch, ticked into
    ``count_dispatches``.
    """
    entries.refuse_fake("gas_scatter_fused", values, dst)
    with trace.span("gas.scatter", values):
        _tick("kernel_scatter")
        entries.note("kernel_scatter", values, weights)
        if values.dim() == 1:
            call = fused_call(dst, values[:, None], weights, mask, n_rows,
                              op=op, schedule=schedule, src=src)
            return call.run()[:n_rows, 0]
        call = fused_call(dst, values, weights, mask, n_rows, op=op,
                          schedule=schedule, src=src)
        return call.run()[:n_rows, :values.shape[1]]


__all__ = ["EdgeSchedule", "KernelCall", "count_dispatches",
           "counting_suspended", "dense_skip_stats", "feat_skip_stats",
           "fused_call", "gas_scatter", "gas_scatter_fused",
           "gas_scatter_ref", "occupancy_map", "row_sorted_index",
           "schedule_edges", "schedule_skip_stats", "suspend_counting"]
