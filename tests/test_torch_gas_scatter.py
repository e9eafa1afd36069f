"""Port parity: the FAST-GAS dispatch layer (``kernels/gas_scatter``).

The schedule (``perm``, ``blk_min``, ``blk_max``, ``work``) and the
occupancy map must equal the JAX package's element for element. The
scatter entries, which on CPU tensors run the kernels' plain versions,
must equal ``repro.kernels.gas_scatter.ops`` (Pallas in interpret mode)
bit for bit on integer-valued data, and within rtol = atol = 1e-5 on
normal data, where the two sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gas_scatter import ops as jops
from repro_torch.kernels.gas_scatter import kernel as K
from repro_torch.kernels.gas_scatter import ops, ref

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _edges(rng, E, n_rows, *, sorted_=False, masked=True, out_of_range=True):
    lo, hi = (-3, n_rows + 3) if out_of_range else (0, n_rows)
    dst = rng.integers(lo, hi, E).astype(np.int32)
    if sorted_:
        dst = np.sort(dst)
    mask = (rng.random(E) < 0.8) if masked else None
    return dst, mask


def _values(rng, E, F, data, zero_blocks):
    if data == "int":
        v = rng.integers(-6, 7, (E, F)).astype(np.float32)
    else:
        v = rng.standard_normal((E, F)).astype(np.float32)
    if zero_blocks:
        v[:, 2:F - 1] = 0.0      # whole feature blocks of zeros
        v[: E // 2] = 0.0        # and whole edge tiles of zeros
    return v


# ---------------------------------------------------------------------------
# the schedule and the occupancy map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,n_rows,sorted_,masked,oor", [
    (300, 200, False, True, True),      # ragged E, dead rows, masks
    (1000, 700, False, False, True),
    (640, 300, True, True, False),      # assume_sorted, interleaved masks
    (256, 1000, True, False, False),    # empty row blocks
    (5, 3, True, True, True),           # one tile
    (129, 128, False, True, True),      # E just past a tile
])
def test_schedule_edges_equals_reference(E, n_rows, sorted_, masked, oor):
    rng = np.random.default_rng(E + n_rows)
    dst, mask = _edges(rng, E, n_rows, sorted_=sorted_, masked=masked,
                       out_of_range=oor)
    js = jops.schedule_edges(_j(dst), _j(mask), n_rows,
                             assume_sorted=sorted_)
    ts = ops.schedule_edges(_t(dst), _t(mask), n_rows, assume_sorted=sorted_)
    for name, a, b in zip(js._fields, js, ts):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert jops.schedule_skip_stats(js) == ops.schedule_skip_stats(ts)
    assert (jops.dense_skip_stats(_j(dst), _j(mask), n_rows)
            == ops.dense_skip_stats(_t(dst), _t(mask), n_rows))


def test_work_list_runs_start_at_their_init_row():
    """Each row block's work rows form one contiguous run that starts at
    its init row: the property the banded kernel's one-CTA-per-run launch
    relies on."""
    rng = np.random.default_rng(0)
    dst, mask = _edges(rng, 2000, 1500)
    work = ops.schedule_edges(_t(dst), _t(mask), 1500).work.numpy()
    rb, init = work[:, 0], work[:, 3]
    assert (np.diff(rb) >= 0).all()
    n_blocks = -(-1500 // 128)
    assert init.sum() == n_blocks
    starts = np.flatnonzero(init)
    np.testing.assert_array_equal(rb[starts], np.arange(n_blocks))
    np.testing.assert_array_equal(starts, np.searchsorted(rb, np.arange(n_blocks)))


@pytest.mark.parametrize("E,n_blocks", [(256, 3), (1024, 8), (128, 1)])
def test_occupancy_map_equals_reference(E, n_blocks):
    rng = np.random.default_rng(E)
    dst = rng.integers(-50, n_blocks * 128 + 50, E).astype(np.int32)
    a = jops.occupancy_map(_j(dst), n_blocks, 128)
    b = ops.occupancy_map(_t(dst), n_blocks)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# the scatter entries
# ---------------------------------------------------------------------------

def _fused_pair(dst, vals, w, mask, n_rows, op, scheduled, sorted_):
    js = ts = None
    if scheduled:
        js = jops.schedule_edges(_j(dst), _j(mask), n_rows,
                                 assume_sorted=sorted_)
        ts = ops.schedule_edges(_t(dst), _t(mask), n_rows,
                                assume_sorted=sorted_)
        perm = np.asarray(js.perm)
        dst, vals = dst[perm], vals[perm]
        w = None if w is None else w[perm]
        mask = None if mask is None else mask[perm]
    with jops.count_dispatches() as jc:
        a = jops.gas_scatter_fused(_j(dst), _j(vals), _j(w), _j(mask), n_rows,
                                   op=op, schedule=js)
    with ops.count_dispatches() as tc:
        b = ops.gas_scatter_fused(_t(dst), _t(vals), _t(w), _t(mask), n_rows,
                                  op=op, schedule=ts)
    assert dict(jc) == dict(tc) == {"kernel_scatter": 1}
    return np.asarray(a), b.numpy()


@pytest.mark.parametrize("op,weighted", [("add", False), ("add", True),
                                         ("max", False), ("min", False)])
@pytest.mark.parametrize("scheduled", [True, False])
@pytest.mark.parametrize("zero_blocks", [False, True])
def test_fused_bitexact_on_integer_data(op, weighted, scheduled, zero_blocks):
    rng = np.random.default_rng([len(op), weighted, scheduled, zero_blocks])
    E, n_rows, F = 700, 300, 70
    dst, mask = _edges(rng, E, n_rows)
    vals = _values(rng, E, F, "int", zero_blocks)
    w = rng.integers(-3, 4, E).astype(np.float32) if weighted else None
    a, b = _fused_pair(dst, vals, w, mask, n_rows, op, scheduled, False)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("scheduled", [True, False])
def test_fused_one_dimensional_values(op, scheduled):
    rng = np.random.default_rng(3)
    E, n_rows = 260, 140
    dst, mask = _edges(rng, E, n_rows)
    vals = rng.integers(-9, 10, E).astype(np.float32)
    a, b = _fused_pair(dst, vals, None, mask, n_rows, op, scheduled, False)
    assert b.shape == (n_rows,)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op,weighted", [("add", True), ("max", False),
                                         ("min", False)])
@pytest.mark.parametrize("scheduled", [True, False])
def test_fused_normal_data_within_tolerance(op, weighted, scheduled):
    rng = np.random.default_rng(11)
    E, n_rows, F = 900, 260, 40
    dst, mask = _edges(rng, E, n_rows, sorted_=True)
    vals = _values(rng, E, F, "normal", zero_blocks=True)
    w = rng.random(E).astype(np.float32) if weighted else None
    a, b = _fused_pair(dst, vals, w, mask, n_rows, op, scheduled, True)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], **TOL)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("scheduled", [True, False])
def test_fused_compare_propagates_nan(op, scheduled):
    """A NaN value on a matched edge makes its row's extremum NaN, as
    ``jnp.maximum`` / ``minimum`` do in the reference; a NaN on a dead edge
    is never read. ``chip_smoke.py`` holds the CUDA kernel to the same."""
    rng = np.random.default_rng(17)
    E, n_rows, F = 500, 200, 12
    dst, mask = _edges(rng, E, n_rows)
    vals = _values(rng, E, F, "int", zero_blocks=False)
    vals[rng.random((E, F)) < 0.01] = np.nan
    a, b = _fused_pair(dst, vals, None, mask, n_rows, op, scheduled, False)
    assert np.isnan(a).any()
    np.testing.assert_array_equal(a, b)     # NaN positions must agree too


@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
@pytest.mark.parametrize("one_d", [False, True])
def test_raw_gas_scatter_bitexact(op, one_d):
    rng = np.random.default_rng(5)
    E, n_rows, F = 333, 200, 9
    dst, _ = _edges(rng, E, n_rows)
    if op == "or":
        vals = rng.integers(0, 2, (E, F)).astype(np.int32)
    else:
        vals = rng.integers(-6, 7, (E, F)).astype(np.float32)
    if one_d:
        vals = vals[:, 0]
    with jops.count_dispatches() as jc:
        a = jops.gas_scatter(_j(dst), _j(vals), n_rows, op=op)
    with ops.count_dispatches() as tc:
        b = ops.gas_scatter(_t(dst), _t(vals), n_rows, op=op)
    assert dict(jc) == dict(tc)
    assert b.dtype == _t(vals).dtype
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_ref_oracle_equals_reference(op):
    from repro.kernels.gas_scatter import ref as jref

    rng = np.random.default_rng(8)
    dst, mask = _edges(rng, 200, 50)
    vals = rng.integers(-6, 7, (200, 5)).astype(np.float32)
    w = rng.integers(-2, 3, 200).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jref.gas_scatter_weighted_ref(_j(dst), _j(vals), _j(w),
                                                 _j(mask), 50, op=op)),
        ref.gas_scatter_weighted_ref(_t(dst), _t(vals), _t(w), _t(mask), 50,
                                     op=op).numpy())


# ---------------------------------------------------------------------------
# the kernel call and the plain versions behind it
# ---------------------------------------------------------------------------

def test_fused_call_shapes_and_feature_liveness():
    """Every op launches the schedule's own (W, 4) work list: the banded
    kernel decides feature-block liveness from the value rows it stages,
    so the call carries no liveness columns."""
    rng = np.random.default_rng(2)
    E, n_rows, F = 300, 130, 70           # F pads to 96: three 32-blocks
    dst, mask = _edges(rng, E, n_rows)
    vals = rng.integers(1, 5, (E, F)).astype(np.float32)
    vals[:, 32:64] = 0.0                  # the middle block is all zero
    sched = ops.schedule_edges(_t(dst), _t(mask), n_rows)
    for op in ("add", "max", "min"):
        call = ops.fused_call(_t(dst), _t(vals), None, _t(mask), n_rows,
                              op=op, schedule=sched)
        assert call.kernel == "gas_scatter_banded"
        work, dstp, valp, R = call.args
        assert R == 256 and tuple(valp.shape) == (384, 96)
        assert work.dtype == torch.int32 and torch.equal(work, sched.work)
        assert tuple(work.shape) == (sched.work.shape[0], 4)
        assert ((dstp == R) | (dstp < n_rows)).all()  # dead rows target R
    live = K.tile_feature_liveness(valp)
    assert tuple(live.shape) == (3, 3)
    assert live[:, 0].all() and not live[:, 1].any() and live[:, 2].all()
    dense = ops.fused_call(_t(dst), _t(vals), None, _t(mask), n_rows,
                           op="max")
    assert dense.kernel == "gas_scatter_dense"
    ids, order, starts, valp, R = dense.args
    assert R == 256 and tuple(valp.shape) == (384, 96)
    assert ids.dtype == order.dtype == starts.dtype == torch.int32
    # the routed stream sorted by row, stably: dead edges last, each row's
    # edges in stream order; starts bound each of the 2 row blocks' runs
    assert tuple(starts.shape) == (3,)
    dstp = torch.where(_t(mask) & (_t(dst) >= 0) & (_t(dst) < n_rows),
                       _t(dst), torch.full_like(_t(dst), R))
    dstp = torch.cat([dstp, torch.full((84,), R, dtype=torch.int32)])
    assert torch.equal(ids, dstp[order.long()])
    assert torch.equal(order.sort().values, torch.arange(384,
                                                         dtype=torch.int32))
    assert (ids[1:] >= ids[:-1]).all()
    same = ids[1:] == ids[:-1]
    assert (order[1:][same] > order[:-1][same]).all()
    assert starts.tolist() == [0, int((dstp < 128).sum()),
                               int((dstp < R).sum())]


def _liveness_columns(valp, tiles):
    """(W, F/32): per work row, does its edge tile hold a value != 0 in
    each 32-feature block? The skip rule as per-row columns, computed apart
    from ``K.tile_feature_liveness``."""
    T, F = valp.shape[0] // 128, valp.shape[1]
    return (valp.reshape(T, 128, F // 32, 32) != 0).any(3).any(1)[tiles.long()]


def _walk_with_columns(call, feat):
    """The banded walk gated by per-work-row liveness columns ``feat`` (W,
    F/32), or by none."""
    work, dstp, valp, R = call.args
    out = torch.empty((R, valp.shape[1]), dtype=valp.dtype)
    for i, (rb, tile, live, init) in enumerate(work.tolist()):
        acc = out[rb * 128:(rb + 1) * 128]
        if init == 1:
            acc.zero_()
        if live == 1:
            K._round_plain(acc, dstp, valp, call.kwargs["weights"], "add",
                           tile, rb * 128,
                           None if feat is None else feat[i])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_plain_version_honours_feature_liveness(dtype):
    """The plain walk skips exactly the all-zero (edge tile × 32-feature)
    blocks of an add: an all-zero block and a -0.0 block are skipped, a
    block whose one nonzero value is NaN is applied. An inf weight on a
    live edge leaves the skipped blocks finite, equal to the walk gated by
    per-row liveness columns, where an unskipped walk makes them NaN."""
    rng = np.random.default_rng(4)
    E, n_rows, F = 256, 128, 128
    dst = _t(rng.integers(0, n_rows, E).astype(np.int32))
    vals = torch.from_numpy(rng.integers(1, 3, (E, F)).astype(np.float32))
    vals[:128, 32:64] = 0.0               # tile 0, block 1: all zero
    vals[:128, 64:96] = -0.0              # block 2: all -0.0
    vals[:128, 96:] = 0.0                 # block 3: one NaN
    vals[5, 100] = float("nan")
    w = torch.from_numpy(rng.integers(-1, 2, E).astype(np.float32))
    w[9] = float("inf")                   # a live edge of tile 0
    vals = vals.to(dtype)
    assert torch.signbit(vals[:128, 64:96]).all()
    sched = ops.schedule_edges(dst, None, n_rows, assume_sorted=True)
    call = ops.fused_call(dst, vals, w, None, n_rows, op="add",
                          schedule=sched)
    work, dstp, valp, R = call.args
    assert tuple(work.shape) == (sched.work.shape[0], 4)
    live = K.tile_feature_liveness(valp)
    assert torch.equal(live[0], torch.tensor([True, False, False, True]))
    assert live[1].all()
    got = call.run()
    assert got.dtype == dtype
    row = int(dst[9])
    assert torch.isfinite(got[row, 32:96]).all()
    assert torch.isnan(got[int(dst[5]), 100])
    feat = _liveness_columns(valp, work[:, 1])
    assert torch.equal(feat, live[work[:, 1].long()])
    torch.testing.assert_close(got, _walk_with_columns(call, feat),
                               rtol=0, atol=0, equal_nan=True)
    unskipped = _walk_with_columns(call, None)
    assert torch.isnan(unskipped[row, 32:96]).all()
    torch.testing.assert_close(got[:, :32], unskipped[:, :32], rtol=0,
                               atol=0, equal_nan=True)


def _run_banded_plain(*args, **kwargs):
    return K.gas_scatter_banded_plain(*args, **kwargs)


def _launch(kernel_name, *args, **kwargs):
    return getattr(K, kernel_name)(*args, **kwargs)


@pytest.mark.parametrize("kernel_name", ["gas_scatter_banded",
                                         "gas_scatter_dense"])
def test_wrappers_check_their_arguments(kernel_name):
    dst = torch.zeros(128, dtype=torch.int32)
    vals = torch.zeros(128, 32)
    order = torch.arange(128, dtype=torch.int32)
    starts = torch.tensor([0, 128], dtype=torch.int32)

    def call(d=dst, v=vals, n=128, **kw):
        a = ((torch.zeros((1, 4), dtype=torch.int32), d, v, n)
             if kernel_name == "gas_scatter_banded"
             else (d, order, starts, v, n))
        return _launch(kernel_name, *a, **kw)

    assert call().shape == (128, 32)                # CPU: the plain version
    with pytest.raises(ValueError):
        call(v=torch.zeros(128, 30))                # F not a 32-multiple
    with pytest.raises(ValueError):
        call(n=100)                                 # rows not a 128-multiple
    with pytest.raises(TypeError):
        call(d=dst.long())
    with pytest.raises(TypeError):
        call(v=vals.double())
    with pytest.raises(ValueError):
        call(op="max", weights=torch.ones(128))     # cmp ops take no weights
    with pytest.raises(ValueError):
        call(v=vals.to("meta"))                     # no kernel, no fallback
    assert K.launch_counts() == {"gas_scatter_banded": 0,
                                 "gas_scatter_dense": 0}


@pytest.mark.parametrize("kernel_name", ["gas_scatter_banded",
                                         "gas_scatter_dense"])
def test_wrappers_check_their_arguments_after_a_warm_call(kernel_name):
    """The wrappers cache their shape, dtype and op checks per call
    signature: a valid call first, then every bad argument is still
    refused, and the valid call still runs."""
    banded = kernel_name == "gas_scatter_banded"
    dst = torch.zeros(256, dtype=torch.int32)
    vals = torch.zeros(256, 64)
    order = torch.arange(256, dtype=torch.int32)
    meta = (torch.zeros((4, 4), dtype=torch.int32) if banded
            else torch.tensor([0, 256], dtype=torch.int32))

    def call(d=dst, v=vals, m=meta, n=128, o=order, **kw):
        a = (m, d, v, n) if banded else (d, o, m, v, n)
        return _launch(kernel_name, *a, **kw)

    for op in ("add", "max"):
        assert call(op=op).shape == (128, 64)          # warms the cache
    with pytest.raises(ValueError):
        call(op="mean")                                 # unknown op
    with pytest.raises(ValueError):
        call(op="max", weights=torch.ones(256))         # cmp ops take no weights
    with pytest.raises(TypeError):
        call(weights=torch.ones(256, dtype=torch.float64))
    with pytest.raises(TypeError):
        call(weights=torch.ones(128))                   # weights of another E
    with pytest.raises(TypeError):
        call(d=dst.long())                              # dst dtype
    with pytest.raises(TypeError):
        call(d=dst[:128])                               # dst shape
    with pytest.raises(TypeError):
        call(v=vals.double())                           # values dtype
    with pytest.raises(ValueError):
        call(v=torch.zeros(256, 48))                    # F not a 32-multiple
    with pytest.raises(ValueError):
        call(v=torch.zeros(256, 2, 32))                 # values not (E, F)
    with pytest.raises(ValueError):
        call(n=100)                                     # rows not a 128-multiple
    with pytest.raises(ValueError):
        call(m=meta.long())                             # work / starts dtype
    with pytest.raises(ValueError):                     # work / starts shape
        call(m=torch.zeros((4, 5) if banded else (3,), dtype=torch.int32))
    if banded:
        with pytest.raises(ValueError):                 # no liveness columns
            call(m=torch.zeros((4, 6), dtype=torch.int32), op="add")
    else:
        with pytest.raises(TypeError):
            call(o=order.long())                        # order dtype
        with pytest.raises(TypeError):
            call(o=order[:128])                         # order shape
    with pytest.raises(ValueError):
        call(v=vals.to("meta"))                         # no kernel, no fallback
    assert call(op="add").shape == (128, 64)
    assert K.launch_counts() == {"gas_scatter_banded": 0,
                                 "gas_scatter_dense": 0}


# ---------------------------------------------------------------------------
# the banded walk's gathered row source
# ---------------------------------------------------------------------------

def _run_gathered(*args, **kwargs):
    return K.gas_scatter_banded_gathered(*args, **kwargs)


def _run_banded(*args, **kwargs):
    return K.gas_scatter_banded(*args, **kwargs)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("F,case", [
    (F, case) for F in (32, 40, 602)
    for case in ("dead_edges", "empty_blocks", "zero_block", "wide_table")])
def test_gathered_walk_equals_the_banded_walk_over_the_rows(F, case):
    """The gathered entry, the banded walk reading ``table[src]`` itself,
    equals ``gas_scatter_banded`` over the stream the old composition
    built (``table[src]``, padded by the wrapper) bit for bit: masked and
    out-of-range edges and a 116-edge tile tail (``dead_edges``), row
    blocks no edge reaches (``empty_blocks``), an all-zero feature block
    skipped under an inf weight (``zero_block``), a table of 8× the rows
    the edges reach (``wide_table``)."""
    rng = np.random.default_rng([F, len(case)])
    E, n_rows = 780, 300                      # 7 tiles: a tail of 116
    V = 512 if case == "wide_table" else 64
    table = rng.standard_normal((V, F)).astype(np.float32)
    src = rng.integers(0, 64, E).astype(np.int32)
    dst, mask = _edges(rng, E, n_rows, masked=case == "dead_edges",
                       out_of_range=case == "dead_edges")
    w = (rng.random(E) + 0.05).astype(np.float32)
    if case == "empty_blocks":
        n_rows = 700                          # edges reach rows < 300 only
    if case == "zero_block":
        table[:, :32] = 0.0
        w[3] = np.inf
    sched = ops.schedule_edges(_t(dst), _t(mask), n_rows)
    perm = sched.perm.long()
    s, d, ww = (_t(a)[perm] for a in (src, dst, w))
    m = None if mask is None else _t(mask)[perm]
    call = ops.fused_call(d, _t(table), ww, m, n_rows, op="add",
                          schedule=sched, src=s)
    assert call.kernel == "gas_scatter_banded_gathered"
    work, dstp, srcp, tablep, R = call.args
    fp = -(-F // 32) * 32
    assert tuple(tablep.shape) == (V, fp) and tuple(srcp.shape) == (896,)
    assert (srcp[E:] == -1).all() and torch.equal(srcp[:E], s)
    old = ops.fused_call(d, _t(table)[s.long()], ww, m, n_rows, op="add",
                         schedule=sched)
    got = _run_gathered(*call.args, **call.kwargs)
    want = _run_banded(*old.args, **old.kwargs)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(call.run()), _bits(want))
    if case == "zero_block":
        assert (got[:, :32] == 0).all()       # skipped, not inf · 0
    if case == "empty_blocks":
        assert (got[300:] == 0).all()
    assert K.launch_counts() == {"gas_scatter_banded": 0,
                                 "gas_scatter_dense": 0}


def test_the_gathered_entry_checks_its_arguments():
    """A warm call first; then each bad argument is refused, and only a
    scheduled add takes a table with ``src=``."""
    work = torch.zeros((3, 4), dtype=torch.int32)
    dst = torch.zeros(256, dtype=torch.int32)
    src = torch.zeros(256, dtype=torch.int32)
    table = torch.ones(10, 64)

    def call(d=dst, s=src, t=table, n=128, **kw):
        return _run_gathered(work, d, s, t, n, **kw)

    assert call().shape == (128, 64)
    with pytest.raises(TypeError):
        call(s=src.long())                          # src dtype
    with pytest.raises(TypeError):
        call(s=src[:128])                           # src of another E
    with pytest.raises(TypeError):
        call(t=table.to(torch.bfloat16))            # f32 tables only
    with pytest.raises(ValueError):
        call(t=torch.ones(10, 48))                  # F not a 32-multiple
    with pytest.raises(ValueError):
        call(t=table.to("meta"))                    # no kernel, no fallback
    assert call(weights=torch.ones(256)).shape == (128, 64)
    sched = ops.schedule_edges(dst, None, 128)
    with pytest.raises(ValueError):
        ops.fused_call(dst, table, None, None, 128, op="add", src=src)
    with pytest.raises(ValueError):
        ops.fused_call(dst, table, None, None, 128, op="max", schedule=sched,
                       src=src)


# ---------------------------------------------------------------------------
# the unscheduled dispatch's row-sorted index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("data", ["int", "normal"])
def test_unscheduled_dispatch_over_hub_rows_equals_the_reference(op, data):
    """An R-MAT stream with no vertex permutation, scattered by source:
    row 0 takes ~0.76^10 of the edges and row block 0 a larger share, so
    the row-sorted walk meets long runs of one row. Dead (masked) and
    out-of-range edges, weights for add. Bit for bit with
    ``gas_scatter_ref`` on integer-valued data, within rtol = atol = 1e-5
    on normal data."""
    from repro_torch.graph.synthetic import rmat

    g = rmat(10, 16, seed=len(op) + len(data))
    rng = np.random.default_rng([len(op), len(data)])
    n_rows, E, F = g.n_vertices, g.src.shape[0], 40
    dst = g.src.copy()
    dst[rng.random(E) < 0.02] = -7                    # out of range
    dst[rng.random(E) < 0.02] = n_rows + 3
    mask = rng.random(E) < 0.9
    hub = np.bincount(dst[mask & (dst >= 0) & (dst < n_rows)])
    assert hub[0] > 0.02 * E and hub[:128].sum() > 0.1 * E
    vals = _values(rng, E, F, data, zero_blocks=False)
    if op != "add":
        vals[rng.random((E, F)) < 0.001] = np.nan
    w = rng.integers(-3, 4, E).astype(np.float32) if op == "add" else None
    if op == "add" and data == "normal":
        w = rng.random(E).astype(np.float32)
    with ops.count_dispatches() as c:
        got = ops.gas_scatter_fused(_t(dst), _t(vals), _t(w), _t(mask),
                                    n_rows, op=op)
    assert dict(c) == {"kernel_scatter": 1}
    contrib = _t(vals) * (_t(w)[:, None] if w is not None else 1.0)
    want = ref.gas_scatter_ref(
        torch.where(_t(mask), _t(dst), torch.full_like(_t(dst), -1)),
        contrib, n_rows, op=op)
    if data == "int":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], **TOL)


def test_gather_backward_sorts_its_index_and_counts_its_bytes(monkeypatch):
    """One gather backward is one kernel scatter on the dense grid, whose
    index is a sort of the edges by row: ``gas.dense.index.bytes`` counts
    28 bytes an edge of the tile-padded stream and 12 a row-block bound,
    and the occupancy map is never built on the way."""
    from repro_torch.core import gas
    from repro_torch.runtime import trace

    def refused(*a, **k):
        raise AssertionError("occupancy_map on the dispatch path")

    monkeypatch.setattr(ops, "occupancy_map", refused)
    rng = np.random.default_rng(6)
    n_rows, F = 300, 40
    table = torch.from_numpy(rng.integers(-3, 4, (n_rows, F)).astype(
        np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(0, n_rows, (70, 5)).astype(np.int32))
    trace.reset()
    with trace.recording(), ops.count_dispatches() as c:
        gas.gas_gather(table, ids, impl="kernel").sum().backward()
    # the forward's find; the backward's reduce and its one kernel scatter
    assert dict(c) == {"find": 1, "reduce": 1, "kernel_scatter": 1}
    E_pad, n_blocks = 384, 3                    # 350 edges; 300 rows
    assert trace.summary()["counters"]["gas.dense.index.bytes"] == \
        28 * E_pad + 12 * (n_blocks + 1)
    want = torch.bincount(ids.reshape(-1).long(), minlength=n_rows)
    assert torch.equal(table.grad, want[:, None].float().expand(-1, F))
    trace.reset()
