"""FAST-GAS scatter kernels: build, bind and launch, beside their plain versions.

The kernels live in ``csrc/gas_scatter.cu`` (CUDA C++ for ``sm_90a``; the
source note there says which TPU kernel each one replaces and what bounds
it). They are compiled with ``nvcc`` into a shared library with a plain C
interface the first time a wrapper launches on a CUDA tensor, and loaded
with ``ctypes``. Nothing is built when this module is imported.

The banded wrapper takes the same arguments as the Pallas entry it
replaces; ``gas_scatter_banded_gathered`` is the same walk reading each
edge's row from a float32 feature table through its source id, where the
banded wrapper reads a value stream its caller gathered; the dense one
takes a row-sorted index of the edges (sorted ids, their order, each row
block's start) where the Pallas entry takes an occupancy map. Each
dispatches on where its tensors lie:

* CUDA tensors launch the kernel on PyTorch's current stream (and add one
  to the wrapper's ``launches`` count); a refused launch raises;
* CPU tensors run the plain PyTorch version in this module, which walks the
  same work list (one vectorised step per work row) or row-sorted index;
* anything else raises, a fake tensor first of all
  (``entries.refuse_fake``). There is no fallback from the kernel to the
  plain version on a CUDA tensor.

Values may be float32, bfloat16 or float16 (one C entry per type, the
output in the values' type, as the Pallas kernels give it); edge weights
are float32 at the C entry and the kernel rounds them to the value type,
as the TPU kernel casts them. For the two narrow types the plain versions
keep the reference's rounding points: a round's products summed in float32,
that sum rounded once to the value type and added into an accumulator of
the value type (``_round_plain``); the source note in ``csrc`` states how
the kernels' cluster split regroups that accumulation.

Tile constants: 128 output rows and 128 edges per round, as on the TPU;
the feature block is 32 (one warp's width) where the TPU used 128 lanes, so
the banded walk's add skips an all-zero block of 128 edges × 32 features
(``tile_feature_liveness``), which the kernel decides from the value rows
it stages for the round and the plain version from the same values.

Both kernels run one thread-block cluster per (row block × feature
block); ``banded_plan`` and ``dense_plan`` pick its size from the shapes
alone (no read of the work list or the index, so no device-to-host sync),
and ``cluster_share`` is the split of a row block's rounds over the
cluster's CTAs that the kernels make: work rows for the banded walk,
32-edge chunks of the row block's sorted run for the dense grid.

The binding is lean, so that a call costs little next to the kernel: the
shape, dtype and op checks and the launch plan are cached per call
signature (shapes, dtypes, op), the ctypes functions are resolved once,
the stream comes from PyTorch's raw query, and the C entries take the cached
plan by address. What a signature cannot show (device, contiguity,
alignment) is checked on every call.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, entries

ROW_BLOCK = 128
EDGE_TILE = 128
FEAT_BLOCK = 32

OPS = {"add": 0, "max": 1, "min": 2}

CHUNK = 32                    # edges per owner-warp ballot
CLUSTER_MAX = 8               # CTAs per cluster, the portable limit
BANDED_THREADS = 256
BANDED_WINDOW = BANDED_THREADS  # round candidates compacted per pass
# one CTA's shared memory, the same layout in both kernels: its partial
# tile, two value blocks, two id and weight stages, the window's round list
# and two sets of 8 warp counts
BANDED_SMEM = 4 * (ROW_BLOCK * FEAT_BLOCK + 2 * EDGE_TILE * FEAT_BLOCK
                   + 2 * 2 * EDGE_TILE + BANDED_WINDOW
                   + 2 * (BANDED_THREADS // 32))
MAX_EDGES = 1 << 31           # the kernels index edges with 32-bit ints

# the value types with a kernel, and the suffix of each one's C entries
VALUE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
# the gathered walk's table types (its C entries' suffixes)
GATHERED_DTYPES = {torch.float32: "f32"}

_SOURCE = Path(__file__).resolve().parent / "csrc" / "gas_scatter.cu"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# ({suffix: banded entry}, {suffix: dense entry}, {suffix: gathered
# entry}, stream query), resolved at the first launch
_entries: Optional[tuple] = None


class _Launch(ctypes.Structure):
    """The C entries' launch descriptor (``GasLaunch`` in the source),
    built once per call signature: ``n_meta`` is W (banded) or E (dense),
    ``n_src`` the gathered walk's table rows (0 elsewhere)."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("n_meta", "n_rows", "F", "op", "cluster", "smem", "n_src")]


def build() -> Path:
    """Compile ``csrc/gas_scatter.cu`` unless this source's library exists
    (``kernels._build``). Returns the library path."""
    return _build.build(_SOURCE)


def _load() -> tuple:
    """({suffix: banded entry}, {suffix: dense entry}, {suffix: gathered
    entry}, stream query), built and bound at first use, keyed by the
    suffixes of ``VALUE_DTYPES`` (``GATHERED_DTYPES``)."""
    global _lib, _entries
    with _lib_lock:
        if _entries is None:
            lib = ctypes.CDLL(str(build()))
            fns = tuple(
                {sfx: getattr(lib, f"gas_scatter_{kind}_{sfx}")
                 for sfx in dtypes.values()}
                for kind, dtypes in (("banded", VALUE_DTYPES),
                                     ("dense", VALUE_DTYPES),
                                     ("banded_gathered", GATHERED_DTYPES)))
            # the descriptor, the index tensors (banded: work, dst; dense:
            # ids, order, starts; gathered: work, dst, src), weights,
            # values (the gathered walk's table), out and the stream
            for table, n_index in zip(fns, (2, 3, 3)):
                for fn in table.values():
                    fn.argtypes = [ctypes.c_void_p] * (n_index + 5)
                    fn.restype = ctypes.c_int
            # the raw handle of PyTorch's current stream on a device index,
            # far cheaper than torch.cuda.current_stream() (chip_smoke.py
            # phase 2 times both)
            _lib, _entries = lib, (*fns, torch._C._cuda_getCurrentRawStream)
    return _entries


# ---------------------------------------------------------------------------
# argument checks shared by both wrappers
# ---------------------------------------------------------------------------

def _check_common(dst, values, n_rows: int, op: str, weights, src=None):
    """``src``: the gathered walk's (E,) source ids, ``values`` then its
    (V, F) table."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if op != "add" and weights is not None:
        raise ValueError("compare ops do not consume edge weights")
    if values.dim() != 2:
        raise ValueError(f"values must be (E, F), got {tuple(values.shape)}")
    E, F = values.shape
    if src is not None:
        if src.dtype != torch.int32 or src.dim() != 1:
            raise TypeError(f"src must be int32 (E,), got {src.dtype} "
                            f"{tuple(src.shape)}")
        if values.dtype not in GATHERED_DTYPES:
            raise TypeError(f"the gathered walk reads float32 tables, got "
                            f"{values.dtype}")
        if E >= MAX_EDGES:
            raise ValueError(f"a table of {E} rows: the kernel takes fewer "
                             f"than 2^31")
        E = src.shape[0]
    if E % EDGE_TILE or F % FEAT_BLOCK or n_rows % ROW_BLOCK:
        raise ValueError(
            f"shapes must be tile multiples: E={E} % {EDGE_TILE}, "
            f"F={F} % {FEAT_BLOCK}, n_rows={n_rows} % {ROW_BLOCK}")
    if E >= MAX_EDGES:
        raise ValueError(f"E={E} edges: the kernels take fewer than 2^31")
    if values.dtype not in VALUE_DTYPES:
        raise TypeError(f"values must be float32, bfloat16 or float16, got "
                        f"{values.dtype}")
    if dst.dtype != torch.int32 or tuple(dst.shape) != (E,):
        raise TypeError(f"dst must be int32 of shape ({E},), got "
                        f"{dst.dtype} {tuple(dst.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (E,)):
        raise TypeError(f"weights must be float32 of shape ({E},)")
    return E, F


# Checked call signatures: (kernel, shapes, dtypes, n_rows, op) -> what the
# launch needs. Everything a signature fixes is checked once, when it is
# first seen; what it cannot show (device, contiguity, alignment) on every
# call. Cleared when full, so a server that meets ever new shapes does not
# grow it without end.
_SIGNATURES: dict = {}
_SIGNATURES_MAX = 1024


class _Checked(NamedTuple):
    plan: "ClusterPlan"
    launch: _Launch     # kept alive for its address
    address: int        # of ``launch``, what the C entry reads
    out_shape: tuple
    empty: bool         # no row or no feature: nothing to launch
    suffix: str         # the values' C entry suffix (``VALUE_DTYPES``)


def _signature(kernel, meta, dst, values, n_rows, op, weights, order=None):
    """``meta``: the work list or ``starts``; ``order``: the dense grid's,
    or the gathered walk's ``src``."""
    return (kernel, meta.shape, dst.shape, values.shape, meta.dtype,
            dst.dtype, values.dtype,
            None if weights is None else (weights.shape, weights.dtype),
            None if order is None else (order.shape, order.dtype),
            n_rows, op)


def _remember(key, plan: "ClusterPlan", n_meta: int, n_rows: int, F: int,
              op: str, dtype: torch.dtype, n_src: int = 0) -> _Checked:
    launch = _Launch(n_meta, n_rows, F, OPS[op], plan.cluster,
                     plan.smem_bytes, n_src)
    checked = _Checked(plan, launch, ctypes.addressof(launch), (n_rows, F),
                       n_rows == 0 or F == 0, VALUE_DTYPES[dtype])
    if len(_SIGNATURES) >= _SIGNATURES_MAX:
        _SIGNATURES.clear()
    _SIGNATURES[key] = checked
    return checked


def _launch(which: int, name: str, checked: _Checked, meta, dst, values,
            weights, order=None):
    """Launch entry ``which`` (0 banded: work ``meta``, ``dst``; 1 dense:
    ids ``dst``, ``order``, starts ``meta``; 2 gathered: work ``meta``,
    ``dst``, src ``order``, the table ``values``) for the values' type
    after the per-call checks:
    every tensor on ``values``' CUDA device and contiguous, ``values``
    16-byte aligned. Returns the output; a refused launch raises."""
    index = values.get_device()
    if meta.get_device() != index or dst.get_device() != index or (
            weights is not None and weights.get_device() != index) or (
            order is not None and order.get_device() != index):
        raise ValueError(f"tensors on different devices: {meta.device}, "
                         f"{dst.device}, {values.device}, "
                         f"{None if weights is None else weights.device}, "
                         f"{None if order is None else order.device}")
    if not (meta.is_contiguous() and dst.is_contiguous()
            and values.is_contiguous()
            and (weights is None or weights.is_contiguous())
            and (order is None or order.is_contiguous())):
        raise ValueError("kernel inputs must be contiguous")
    vp = values.data_ptr()
    if vp % 16:
        raise ValueError("values must be 16-byte aligned")
    out = values.new_empty(checked.out_shape)
    if checked.empty:
        return out
    entries = _entries or _load()
    entry = entries[which][checked.suffix]
    wp = None if weights is None else weights.data_ptr()
    stream = entries[3](index)
    if which == 0:
        rc = entry(checked.address, meta.data_ptr(), dst.data_ptr(), wp, vp,
                   out.data_ptr(), stream)
    elif which == 1:
        rc = entry(checked.address, dst.data_ptr(), order.data_ptr(),
                   meta.data_ptr(), wp, vp, out.data_ptr(), stream)
    else:
        rc = entry(checked.address, meta.data_ptr(), dst.data_ptr(),
                   order.data_ptr(), wp, vp, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed ({checked.plan}): CUDA "
                           f"error {rc}")
    return out


def _identity(op: str) -> float:
    return {"add": 0.0, "max": float("-inf"), "min": float("inf")}[op]


def _reduce_rows(acc, rel, contrib, op: str):
    """acc (128, F) ⊕= contrib (n, F) at rows rel (n,): one vectorised step."""
    if op == "add":
        acc.index_add_(0, rel, contrib)
    else:
        idx = rel[:, None].expand(-1, acc.shape[1])
        acc.scatter_reduce_(0, idx, contrib, "amax" if op == "max" else "amin",
                            include_self=True)


def _round_plain(acc, dst, values, weights, op: str, tile: int, row0: int,
                 feat_live=None):
    """One (row block × edge tile) round of the plain version. A bfloat16
    or float16 add follows the reference's rounding points: the weights
    rounded to the value type, the round's products summed in float32, the
    sum rounded to the value type and added into ``acc`` in its type."""
    sl = slice(tile * EDGE_TILE, (tile + 1) * EDGE_TILE)
    rel = dst[sl].long() - row0
    hit = (rel >= 0) & (rel < ROW_BLOCK)
    narrow_add = op == "add" and values.dtype != torch.float32
    contrib = values[sl].float() if narrow_add else values[sl]
    if weights is not None:
        w = weights[sl, None]
        contrib = contrib * (w.to(values.dtype).float() if narrow_add else w)
    if feat_live is not None:
        # an all-zero feature block contributes nothing this round
        cols = feat_live.repeat_interleave(FEAT_BLOCK)
        contrib = torch.where(cols[None, :], contrib,
                              torch.zeros((), dtype=contrib.dtype,
                                          device=contrib.device))
    if narrow_add:
        sums = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
        sums.index_add_(0, rel[hit], contrib[hit])
        acc.copy_(acc.float() + sums.to(acc.dtype).float())
        return
    _reduce_rows(acc, rel[hit], contrib[hit], op)


# ---------------------------------------------------------------------------
# the banded (scheduled) walk
# ---------------------------------------------------------------------------

def tile_feature_liveness(values) -> torch.Tensor:
    """(E/128, F/32) bool: does each 128-edge tile of ``values`` (E, F)
    hold a nonzero value in each 32-feature block? Zero is where ``v != 0``
    is false, so -0.0 is zero and NaN is not. A banded add skips the round
    of a block without one, as the kernel decides from the rows it
    stages."""
    E, F = values.shape
    return (values.reshape(E // EDGE_TILE, EDGE_TILE, F // FEAT_BLOCK,
                           FEAT_BLOCK) != 0).any(3).any(1)


def gas_scatter_banded_plain(work, dst, values, n_rows: int, *,
                             op: str = "add", weights=None):
    """Plain PyTorch version of the banded kernel: walks the work list row
    by row — an init row resets its row block to the identity, a live row
    reduces its edge tile into the block (for add, only the feature blocks
    ``tile_feature_liveness`` finds live)."""
    E, F = _check_common(dst, values, n_rows, op, weights)
    out = torch.empty((n_rows, F), dtype=values.dtype, device=values.device)
    feat = tile_feature_liveness(values) if op == "add" else None
    for rb, tile, live, init in work.tolist():
        acc = out[rb * ROW_BLOCK:(rb + 1) * ROW_BLOCK]
        if init == 1:
            acc.fill_(_identity(op))
        if live != 1:
            continue
        _round_plain(acc, dst, values, weights, op, tile, rb * ROW_BLOCK,
                     None if feat is None else feat[tile])
    return out


class ClusterPlan(NamedTuple):
    """A kernel's launch: CTAs per cluster, the grid (banded: row blocks ×
    cluster, feature blocks; dense: row blocks × feature blocks × cluster,
    1), threads per CTA and dynamic shared bytes."""
    cluster: int
    grid: tuple
    threads: int
    smem_bytes: int


def banded_plan(W: int, n_rows: int, F: int) -> ClusterPlan:
    """One cluster per (row block × feature block), as many CTAs as the
    mean run of the work list has rows (``ceil(W / row_blocks)``), between
    1 and ``CLUSTER_MAX``. One inference chunk (W = 9, one row block,
    F = 608) gets 8 × 19 = 152 CTAs."""
    n_blocks = n_rows // ROW_BLOCK
    per_block = -(-W // n_blocks) if n_blocks else 0
    cluster = max(1, min(CLUSTER_MAX, per_block))
    return ClusterPlan(cluster, (n_blocks * cluster, F // FEAT_BLOCK),
                       BANDED_THREADS, BANDED_SMEM)


def cluster_share(lo: int, hi: int, rank: int, cluster: int):
    """Rounds [start, end) that CTA ``rank`` of a cluster applies from its
    row block's rounds [lo, hi): the rank-th of ``cluster`` contiguous
    shares, as the kernels split them (empty when there are fewer rounds
    than CTAs). The banded walk splits work rows; the dense grid splits the
    32-edge chunks of its row block's run of the sorted stream. The
    partials combine in rank order, which is stream order."""
    n = hi - lo
    return lo + n * rank // cluster, lo + n * (rank + 1) // cluster


def _banded_checked(key, work, dst, values, n_rows, op, weights,
                    src=None) -> _Checked:
    """``src``: the gathered walk's, ``values`` then its table."""
    E, F = _check_common(dst, values, n_rows, op, weights, src)
    if work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 4:
        raise ValueError(f"work must be int32 (W, 4), got {work.dtype} "
                         f"{tuple(work.shape)}")
    W = work.shape[0]
    return _remember(key, banded_plan(W, n_rows, F), W, n_rows, F, op,
                     values.dtype, 0 if src is None else values.shape[0])


def gas_scatter_banded(work, dst, values, n_rows: int, *, op: str = "add",
                       weights=None):
    """Scheduled FAST-GAS scatter-reduce: walks each row block's own run of
    the work list (``ops.schedule_edges``). ``work``: (W, 4) int32 rows
    [row_block, tile, live, init] ordered by row block; dst (E,) int32 with
    dead edges at ``n_rows``; values (E, F) float32, bfloat16 or float16;
    weights (E,) float32 or None (add only). An add skips a live row's
    all-zero feature blocks (``tile_feature_liveness``), which the kernel
    finds in the value rows it stages. Returns (n_rows, F) in the values'
    type.
    """
    entries.refuse_fake("gas_scatter_banded", values, dst)
    key = _signature("banded", work, dst, values, n_rows, op, weights)
    checked = _SIGNATURES.get(key) or _banded_checked(
        key, work, dst, values, n_rows, op, weights)
    if values.is_cuda:
        out = _launch(0, "gas_scatter_banded", checked, work, dst, values,
                      weights)
        if not checked.empty:
            gas_scatter_banded.launches += 1
            gas_scatter_banded.launches_by_dtype[checked.suffix] += 1
        return out
    if values.device.type == "cpu":
        with torch.no_grad():     # forward-only, as the kernel is
            return gas_scatter_banded_plain(work, dst, values, n_rows, op=op,
                                            weights=weights)
    raise ValueError(f"no kernel for device {values.device}")


gas_scatter_banded.launches = 0
gas_scatter_banded.launches_by_dtype = dict.fromkeys(VALUE_DTYPES.values(), 0)


def gathered_rows(table, src) -> torch.Tensor:
    """The (E, F) rows the gathered walk stages: ``table[src[e]]``, and
    zeros where ``src[e]`` lies outside the table (the tile padding's)."""
    ok = (src >= 0) & (src < table.shape[0])
    rows = table[torch.where(ok, src, torch.zeros_like(src)).long()]
    return torch.where(ok[:, None], rows,
                       torch.zeros((), dtype=table.dtype, device=table.device))


def gas_scatter_banded_gathered_plain(work, dst, src, table, n_rows: int, *,
                                      op: str = "add", weights=None):
    """Plain PyTorch version of the gathered walk: the banded walk's
    (``gas_scatter_banded_plain``) over the rows ``gathered_rows(table,
    src)``."""
    _check_common(dst, table, n_rows, op, weights, src)
    return gas_scatter_banded_plain(work, dst, gathered_rows(table, src),
                                    n_rows, op=op, weights=weights)


def gas_scatter_banded_gathered(work, dst, src, table, n_rows: int, *,
                                op: str = "add", weights=None):
    """The banded walk over the rows ``table[src]``, read from the table
    by the kernel: no (E, F) stream is built. ``src`` (E,) int32 in stream
    order beside ``dst``; a source id outside ``[0, V)`` (the tile
    padding's) stages a zero row. ``table`` (V, F) float32, F a multiple
    of 32; the rest as ``gas_scatter_banded``, whose plain version over
    those rows this equals bit for bit. Its launches count as the banded
    wrapper's (one kernel, two row sources)."""
    entries.refuse_fake("gas_scatter_banded_gathered", table, dst, src)
    key = _signature("gathered", work, dst, table, n_rows, op, weights, src)
    checked = _SIGNATURES.get(key) or _banded_checked(
        key, work, dst, table, n_rows, op, weights, src)
    if table.is_cuda:
        out = _launch(2, "gas_scatter_banded_gathered", checked, work, dst,
                      table, weights, src)
        if not checked.empty:
            gas_scatter_banded.launches += 1
            gas_scatter_banded.launches_by_dtype[checked.suffix] += 1
        return out
    if table.device.type == "cpu":
        with torch.no_grad():     # forward-only, as the kernel is
            return gas_scatter_banded_gathered_plain(
                work, dst, src, table, n_rows, op=op, weights=weights)
    raise ValueError(f"no kernel for device {table.device}")


# ---------------------------------------------------------------------------
# the dense grid over a row-sorted index
# ---------------------------------------------------------------------------

def gas_scatter_dense_plain(ids, order, starts, values, n_rows: int, *,
                            op: str = "add", weights=None):
    """Plain PyTorch version of the dense-grid kernel: walks the row-sorted
    index (sorted position p carries edge ``order[p]`` into row ``ids[p]``;
    positions from ``starts[-1]`` on are dead), each row's edges in stream
    order from the identity, in one vectorised step. A bfloat16 or float16
    add keeps the reference's rounding points, one per (row block × edge
    tile) round: a row's products of one source tile summed in float32 (one
    step over every such run), rounded once and added into the row in the
    value type, tile after tile (one step per run rank within a row)."""
    E, F = _check_dense(ids, order, starts, values, n_rows, op, weights)
    out = torch.full((n_rows, F), _identity(op), dtype=values.dtype,
                     device=values.device)
    live = int(starts[-1])
    rows, edges = ids[:live].long(), order[:live].long()
    narrow_add = op == "add" and values.dtype != torch.float32
    contrib = values[edges].float() if narrow_add else values[edges]
    if weights is not None:
        w = weights[edges, None]
        contrib = contrib * (w.to(values.dtype).float() if narrow_add else w)
    if not narrow_add:
        _reduce_rows(out, rows, contrib, op)
        return out
    if live == 0:
        return out
    # a run: consecutive positions of one row and one source tile
    tiles = edges // EDGE_TILE
    new = torch.ones(live, dtype=torch.bool, device=values.device)
    new[1:] = (rows[1:] != rows[:-1]) | (tiles[1:] != tiles[:-1])
    run = torch.cumsum(new, 0) - 1
    sums = torch.zeros((int(run[-1]) + 1, F), dtype=torch.float32,
                       device=values.device).index_add_(0, run, contrib)
    run_rows = rows[new]
    # each run's place among its row's runs (a row's runs are consecutive)
    at = torch.arange(run_rows.shape[0], device=values.device)
    first = torch.ones_like(at, dtype=torch.bool)
    first[1:] = run_rows[1:] != run_rows[:-1]
    place = at - torch.cummax(torch.where(first, at, torch.zeros_like(at)),
                              0).values
    for k in range(int(place.max()) + 1):
        sel = place == k
        r = run_rows[sel]
        out[r] = (out[r].float() + sums[sel].to(values.dtype).float()
                  ).to(values.dtype)
    return out


def dense_plan(E: int, n_rows: int, F: int) -> ClusterPlan:
    """One cluster per (row block × feature block), one CTA per 32-edge
    chunk of a row block's mean share of the ``E`` edges
    (``ceil(E / (32 · row_blocks))``), between 1 and ``CLUSTER_MAX``. The
    index is never read on the host: a row block with fewer edges leaves
    some CTAs of its cluster without a chunk. One 3-seed serving segment
    (E = 256, one row block, F = 608) gets 8 × 19 = 152 CTAs. The C entry
    builds this plan only."""
    n_blocks = n_rows // ROW_BLOCK
    chunks = -(-E // (CHUNK * n_blocks)) if n_blocks else 0
    cluster = max(1, min(CLUSTER_MAX, chunks))
    # one-dimensional: a row block's feature blocks are launched together
    return ClusterPlan(cluster, (n_blocks * (F // FEAT_BLOCK) * cluster, 1),
                       BANDED_THREADS, BANDED_SMEM)


def _check_dense(ids, order, starts, values, n_rows, op, weights):
    E, F = _check_common(ids, values, n_rows, op, weights)
    if order.dtype != torch.int32 or tuple(order.shape) != (E,):
        raise TypeError(f"order must be int32 of shape ({E},), got "
                        f"{order.dtype} {tuple(order.shape)}")
    n_starts = n_rows // ROW_BLOCK + 1
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_starts,):
        raise ValueError(f"starts must be int32 ({n_starts},), got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    return E, F


def _dense_checked(key, ids, order, starts, values, n_rows, op,
                   weights) -> _Checked:
    E, F = _check_dense(ids, order, starts, values, n_rows, op, weights)
    return _remember(key, dense_plan(E, n_rows, F), E, n_rows, F, op,
                     values.dtype)


def gas_scatter_dense(ids, order, starts, values, n_rows: int, *,
                      op: str = "add", weights=None):
    """Unscheduled FAST-GAS scatter-reduce over the (n_rows/128, F/32) grid
    of output tiles, walking a row-sorted index (``ops.row_sorted_index``):
    ``ids`` (E,) int32 the routed rows sorted stably (dead edges at
    ``n_rows``, last), ``order`` (E,) int32 the edge at each sorted
    position, ``starts`` (n_rows/128 + 1,) int32 each row block's first
    position. Each cluster walks its row block's run, its CTAs on
    contiguous shares of the run's 32-edge chunks; weights and values are
    read through ``order``. values (E, F) float32, bfloat16 or float16 and
    weights (E,) float32 or None (add only), both in stream order. Returns
    (n_rows, F) in the values' type."""
    entries.refuse_fake("gas_scatter_dense", values, ids, order, starts)
    key = _signature("dense", starts, ids, values, n_rows, op, weights,
                     order)
    checked = _SIGNATURES.get(key) or _dense_checked(
        key, ids, order, starts, values, n_rows, op, weights)
    if values.is_cuda:
        out = _launch(1, "gas_scatter_dense", checked, starts, ids, values,
                      weights, order)
        if not checked.empty:
            gas_scatter_dense.launches += 1
            gas_scatter_dense.launches_by_dtype[checked.suffix] += 1
        return out
    if values.device.type == "cpu":
        with torch.no_grad():     # forward-only, as the kernel is
            return gas_scatter_dense_plain(ids, order, starts, values,
                                           n_rows, op=op, weights=weights)
    raise ValueError(f"no kernel for device {values.device}")


gas_scatter_dense.launches = 0
gas_scatter_dense.launches_by_dtype = dict.fromkeys(VALUE_DTYPES.values(), 0)


def reset_launch_counts() -> None:
    for wrapper in (gas_scatter_banded, gas_scatter_dense):
        wrapper.launches = 0
        wrapper.launches_by_dtype = dict.fromkeys(VALUE_DTYPES.values(), 0)


def launch_counts() -> dict:
    """Launches per wrapper, every value type together."""
    return {"gas_scatter_banded": gas_scatter_banded.launches,
            "gas_scatter_dense": gas_scatter_dense.launches}


def dtype_launch_counts() -> dict:
    """Launches per wrapper and value type: ``{wrapper: {suffix: n}}``."""
    return {"gas_scatter_banded": dict(gas_scatter_banded.launches_by_dtype),
            "gas_scatter_dense": dict(gas_scatter_dense.launches_by_dtype)}
