"""Port parity: bfloat16 (and float16) feature tables served end to end.

The same seeded numpy inputs go through the JAX package and the port, in a
narrow value type:

* both FAST-GAS kernels' plain versions (through ``gas_scatter_fused``, on
  the banded walk and on the dense grid) against the JAX package's Pallas
  kernels in interpret mode: bit for bit on integer data and for max / min
  on normal data; add on normal data within the JAX package's own bf16
  bound (``tests/test_kernels_gas.py::test_dtype_sweep``: atol 0.2, rtol
  0.05 against the float32 sum) and at the measured distance from JAX's
  bits. One float16 case of each kernel;
* ``aggregate_multi`` on a bf16 table, unsharded (``impl="ref"`` against
  ``"xla"``, ``"kernel"`` against ``"pallas"``), and on a 2-rank gloo mesh
  with the f32, bf16 and int8 wires and ``features="sparse"`` against the
  unsharded port;
* the serving engine: bf16 rows bit for bit through real cache hits,
  integer and float64 tables served as float32, the port against the JAX
  engine on integer data, one float16 engine, the engine over 2 gloo ranks
  with its collectives and bytes (``analysis/budgets.py``), and
  ``fetch_callable``'s counted dispatches and collectives;
* the gather backward on a bf16 table, the ``COOGraph`` helpers and
  ``feat_skip_stats``.

The gloo ranks import this module, so it imports JAX only inside the
functions that compute the reference (``_jax``); each rank reports the
foreign modules it holds.
"""

import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.analysis import budgets
from repro_torch.core import cgtrans, collectives, gas
from repro_torch.core.sparse import sparse_fits, table_capacity
from repro_torch.graph.structure import COOGraph
from repro_torch.kernels.gas_scatter import kernel as K
from repro_torch.kernels.gas_scatter import ops
from repro_torch.launch import mesh as meshlib
from repro_torch.serving import ServingEngine

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores (every spawned rank sets the same).
torch.set_num_threads(1)

TIMEOUT_S = 300
NARROW = {"bf16": torch.bfloat16, "f16": torch.float16}


def _jax():
    """The JAX package's modules, imported on first use."""
    import jax.numpy as jnp

    from repro.core import cgtrans as jcgtrans
    from repro.core import gas as jgas
    from repro.graph import structure as jstructure
    from repro.graph import uniform_graph
    from repro.kernels.gas_scatter import ops as jops
    from repro.serving import ServingEngine as JServingEngine

    return types.SimpleNamespace(
        jnp=jnp, cgtrans=jcgtrans, gas=jgas, structure=jstructure,
        uniform_graph=uniform_graph, ops=jops, ServingEngine=JServingEngine)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _narrow(x, name="bf16"):
    """float32 numpy → the port's narrow tensor and the JAX array."""
    jx = _jax()
    return (_t(x).to(NARROW[name]),
            jx.jnp.asarray(x, jx.jnp.bfloat16 if name == "bf16"
                           else jx.jnp.float16))


def _bits(x):
    """The bits of a 2-byte tensor or array, as int16 numpy."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels: plain versions against the JAX package's kernels
# ---------------------------------------------------------------------------

E_K, F_K, ROWS_K = 1536, 40, 300


def _kernel_inputs(data, seed=0):
    """An edge stream over 3 row blocks, a tenth of its edges masked or out
    of range; integer data keeps every partial sum within 256."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(-2, ROWS_K + 2, E_K)).astype(np.int32)
    mask = rng.random(E_K) < 0.9
    if data == "int":
        vals = rng.integers(-2, 3, (E_K, F_K))
        w = rng.integers(-1, 2, E_K)
    else:
        vals = rng.standard_normal((E_K, F_K))
        w = rng.standard_normal(E_K)
    return dst, vals.astype(np.float32), w.astype(np.float32), mask


def _both_fused(route, op, weighted, data, dtype="bf16", seed=0):
    """(port result, JAX interpret-mode result, float32 sum of the same
    narrow inputs) of one fused scatter on ``route``."""
    jx = _jax()
    dst, vals, w, mask = _kernel_inputs(data, seed)
    sched = jsched = None
    if route == "banded":
        sched = ops.schedule_edges(_t(dst), _t(mask), ROWS_K)
        jsched = jx.ops.schedule_edges(jx.jnp.asarray(dst),
                                       jx.jnp.asarray(mask), ROWS_K)
        perm = sched.perm.numpy()
        dst, vals, w, mask = dst[perm], vals[perm], w[perm], mask[perm]
    tv, jv = _narrow(vals, dtype)
    wt = w if weighted else None
    got = ops.gas_scatter_fused(_t(dst), tv, None if wt is None else _t(wt),
                                _t(mask), ROWS_K, op=op, schedule=sched)
    want = jx.ops.gas_scatter_fused(
        jx.jnp.asarray(dst), jv, None if wt is None else jx.jnp.asarray(wt),
        jx.jnp.asarray(mask), ROWS_K, op=op, schedule=jsched, interpret=True)
    # the f32 sum of the narrow values and rounded weights
    vf = tv.float()
    if op == "add" and weighted:
        vf = vf * _t(w).to(NARROW[dtype]).float()[:, None]
    exact = ops.gas_scatter_fused(_t(dst), vf, None, _t(mask), ROWS_K, op=op,
                                  schedule=sched)
    return got, want, exact.numpy()


KERNEL_CASES = [("add", False), ("add", True), ("max", False),
                ("min", False)]


@pytest.mark.parametrize("route", ["banded", "dense"])
@pytest.mark.parametrize("op,weighted", KERNEL_CASES)
def test_plain_kernels_equal_the_jax_kernels_on_integer_data(route, op,
                                                             weighted):
    got, want, exact = _both_fused(route, op, weighted, "int")
    assert got.dtype == torch.bfloat16 and got.shape == (ROWS_K, F_K)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    fin = np.isfinite(exact)
    np.testing.assert_array_equal(_f32(got)[fin], exact[fin])


@pytest.mark.parametrize("route", ["banded", "dense"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_compare_ops_are_bit_exact_on_normal_data(route, op):
    got, want, exact = _both_fused(route, op, False, "normal", seed=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_f32(got), exact)


@pytest.mark.parametrize("route", ["banded", "dense"])
@pytest.mark.parametrize("weighted", [False, True])
def test_add_on_normal_data_keeps_the_reference_rounding(route, weighted):
    """Within the JAX package's bf16 bound of the float32 sum, and at the
    measured distance from the JAX kernel's bits: none, as the plain
    version rounds where the reference does (a round's float32 sum
    rounded once, added into a bf16 accumulator)."""
    got, want, exact = _both_fused(route, "add", weighted, "normal", seed=2)
    np.testing.assert_allclose(_f32(got), exact, atol=0.2, rtol=0.05)
    assert float(np.abs(_f32(got) - _f32(want)).max()) == 0.0
    assert float(np.abs(_f32(got) - exact).max()) > 0.0   # it did round


@pytest.mark.parametrize("route", ["banded", "dense"])
def test_f16_kernels_equal_the_jax_kernels(route):
    """The float16 instantiation: bit for bit on integer data for every
    op; add with weights on normal data within 2^-13 of JAX's bits (its
    interpret-mode float16 dot sums a round in another order) and within
    the bf16 bound of the float32 sum."""
    for op, weighted in KERNEL_CASES:
        got, want, exact = _both_fused(route, op, weighted, "int", "f16")
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    got, want, exact = _both_fused(route, "add", True, "normal", "f16", 3)
    assert float(np.abs(_f32(got) - _f32(want)).max()) <= 2.0 ** -13
    np.testing.assert_allclose(_f32(got), exact, atol=0.2, rtol=0.05)


def _run(kernel, *args, **kwargs):
    """A kernel wrapper of ``kernel.py`` by name (a private helper, as the
    repo's AST lint asks of tests that reach the raw entries)."""
    return getattr(K, kernel)(*args, **kwargs)


def test_wrappers_take_the_narrow_types_and_never_fall_back():
    """bf16 and f16 values reach their own plain version on the CPU; on any
    other device the wrappers launch or raise, and no other float type is
    taken."""
    work = torch.tensor([[0, 0, 1, 1]], dtype=torch.int32)
    dst = torch.zeros(128, dtype=torch.int32)
    index = (dst, torch.arange(128, dtype=torch.int32),
             torch.tensor([0, 128], dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float16):
        vals = torch.ones((128, 32), dtype=dtype)
        out = _run("gas_scatter_banded", work, dst, vals, 128)
        assert out.dtype == dtype and float(out[0, 0]) == 128.0
        out = _run("gas_scatter_dense", *index, vals, 128)
        assert out.dtype == dtype and float(out[0, 0]) == 128.0
        with pytest.raises(ValueError, match="no kernel for device meta"):
            _run("gas_scatter_banded", work.to("meta"), dst.to("meta"),
                 vals.to("meta"), 128)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        _run("gas_scatter_dense", *index,
             torch.ones((128, 32), dtype=torch.float64), 128)
    assert set(K.VALUE_DTYPES.values()) == {"f32", "bf16", "f16"}
    assert K.dtype_launch_counts() == {
        name: {"f32": 0, "bf16": 0, "f16": 0}
        for name in ("gas_scatter_banded", "gas_scatter_dense")}


def test_gather_backward_on_a_bf16_table():
    """The kernel route's gather backward scatters the cotangent in float32
    and casts back to the table's dtype, as JAX's does."""
    jx = _jax()
    rng = np.random.default_rng(4)
    table = rng.integers(-3, 4, (50, 40)).astype(np.float32)
    ids = rng.integers(0, 50, (30, 3)).astype(np.int32)
    cot = rng.integers(-2, 3, (30, 3, 40)).astype(np.float32)
    tt, jt = _narrow(table)
    tt.requires_grad_(True)
    (gas.gas_gather(tt, _t(ids), impl="kernel").float() * _t(cot)).sum(
        ).backward()
    import jax

    jg = jax.grad(lambda t: (jx.gas.gas_gather(
        t, jx.jnp.asarray(ids), impl="pallas").astype(jx.jnp.float32)
        * cot).sum())(jt)
    assert tt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tt.grad), _bits(jg))


# ---------------------------------------------------------------------------
# aggregate_multi on a bf16 table
# ---------------------------------------------------------------------------

P_W, PART_W, F_W = 2, 32, 40
SEGMENTS_W = ((6, 1), (6, 4))       # the sage pair: lookup + fan-out


def _agg_world():
    """A (2, 32, 40) integer table and its sparse twin (seven in ten
    entries zero), two request segments with dead ids and masks."""
    rng = np.random.default_rng(5)
    feats = rng.integers(-3, 4, (P_W, PART_W, F_W)).astype(np.float32)
    sparse = np.where(rng.random(feats.shape) < 0.3, feats, 0.0).astype(
        np.float32)
    V = P_W * PART_W
    blocks = [(rng.integers(-1, V + 1, (P_W, r, k)).astype(np.int32),
               rng.random((P_W, r, k)) < 0.8) for r, k in SEGMENTS_W]
    return {"feats": feats, "sparse": sparse, "blocks": blocks,
            "cap": table_capacity(sparse.reshape(-1, F_W))}


@pytest.mark.parametrize("impl,scheduled,chunk", [
    ("ref", None, None), ("kernel", True, None), ("kernel", False, None),
    ("kernel", True, 4)])
@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
def test_aggregate_multi_on_a_bf16_table_equals_jax(impl, scheduled, chunk,
                                                    op):
    jx = _jax()
    world = _agg_world()
    tt, jt = _narrow(world["feats"])
    kw = dict(op=op, scheduled=scheduled, request_chunk=chunk)
    got = cgtrans.aggregate_multi(
        tt, [(_t(n), _t(m)) for n, m in world["blocks"]], impl=impl, **kw)
    want = jx.cgtrans.aggregate_multi(
        jt, [(jx.jnp.asarray(n), jx.jnp.asarray(m))
             for n, m in world["blocks"]],
        impl={"ref": "xla", "kernel": "pallas"}[impl], **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_wire_and_sparse_are_no_ops_on_an_unsharded_bf16_table():
    world = _agg_world()
    table = _t(world["sparse"]).to(torch.bfloat16)
    assert sparse_fits(world["cap"], F_W)
    blocks = [(_t(n), _t(m)) for n, m in world["blocks"]]
    base = cgtrans.aggregate_multi(table, blocks, impl="kernel")
    for kw in (dict(wire="bf16"), dict(wire="int8"),
               dict(features="sparse", sparse_capacity=world["cap"])):
        for g, w in zip(cgtrans.aggregate_multi(table, blocks, impl="kernel",
                                                **kw), base):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

V_E, F_E = 64, 40


def _fake_clock(step=0.001):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def _serving_world():
    jx = _jax()
    g = jx.uniform_graph(V_E, 6 * V_E, seed=3)
    indptr, indices, _ = g.to_csr()
    feats = np.random.default_rng(6).integers(-5, 6, (V_E, F_E)).astype(
        np.float32)
    return feats, indptr, indices


def _engine(feats, indptr, indices, **kw):
    return ServingEngine(feats, indptr, indices, fanout=4,
                         clock=_fake_clock(), sample_seed=0, device="cpu",
                         **{"max_batch": 4, "cache_capacity": 8, **kw})


def _serve(eng, seeds_list):
    rids = [eng.submit(s, tenant=j % 3) for j, s in enumerate(seeds_list)]
    eng.poll()
    eng.flush()
    return [eng.result(r) for r in rids]


def _seeds(n=9):
    rng = np.random.default_rng(1)
    hot = rng.integers(0, V_E, 4)
    return [rng.choice(hot, int(rng.integers(1, 4))) for _ in range(n)]


@pytest.mark.parametrize("given", ["numpy", "tensor"])
def test_bf16_feature_table_served_bitexact(given):
    """``tests/test_serving.py``'s bf16 case: results come back in bf16
    (``torch.bfloat16`` tensors on the host) and cache-on ≡ cache-off bit
    for bit through real hits, whether the table is a numpy bfloat16 array
    or a ``torch.bfloat16`` tensor."""
    feats, indptr, indices = _serving_world()
    tt, jt = _narrow(feats)
    table = np.asarray(jt) if given == "numpy" else tt
    res = {}
    seeds = np.random.default_rng(7).integers(0, V_E, 4)
    for cap in (0, V_E):
        eng = _engine(table, indptr, indices, cache_capacity=cap,
                      max_batch=8)
        assert eng.feat_dtype == torch.bfloat16
        assert eng.feats.dtype == torch.bfloat16
        rids = []
        for batch in (seeds, seeds):        # second batch = all repeats
            rids += [eng.submit([int(s)], tenant=100 + j)
                     for j, s in enumerate(batch)]
            assert eng.flush() == len(batch)
        res[cap] = [eng.result(r) for r in rids]
        if cap:
            assert eng.cache.hits > 0
    for a, b in zip(res[0], res[V_E]):
        assert a.self_rows.dtype == torch.bfloat16
        assert torch.equal(a.self_rows, b.self_rows)
        assert torch.equal(a.agg_rows, b.agg_rows)
    np.testing.assert_array_equal(
        _f32(res[0][0].self_rows), feats[seeds[:1]])


def test_non_float_and_f64_tables_are_served_as_f32():
    feats, indptr, indices = _serving_world()
    for table in (feats.astype(np.int32), feats.astype(np.float64),
                  _t(feats).double()):
        eng = _engine(table, indptr, indices)
        assert eng.feat_dtype == np.float32
        assert eng.feats.dtype == torch.float32
        rid = eng.submit([3])
        eng.flush()
        assert eng.result(rid).self_rows.dtype == np.float32


@pytest.mark.parametrize("impl,scheduled,op", [
    ("ref", None, "add"), ("ref", None, "max"),
    ("kernel", True, "add"), ("kernel", True, "max"),
    ("kernel", False, "add"), ("kernel", False, "min")])
def test_bf16_engine_equals_the_jax_engine(impl, scheduled, op):
    """``impl="ref"`` against JAX's ``"xla"`` and ``"kernel"`` against
    ``"pallas"`` on an integer bf16 table, hot cache on: the same bits,
    statistics and cache counters."""
    jx = _jax()
    feats, indptr, indices = _serving_world()
    tt, jt = _narrow(feats)
    kw = dict(fanout=4, op=op, max_batch=4, cache_capacity=8,
              scheduled=scheduled, sample_seed=5)
    a = jx.ServingEngine(np.asarray(jt), indptr, indices,
                         impl={"ref": "xla", "kernel": "pallas"}[impl],
                         clock=_fake_clock(), **kw)
    b = ServingEngine(tt, indptr, indices, impl=impl, device="cpu",
                      clock=_fake_clock(), **kw)
    seeds = _seeds()
    for x, y in zip(_serve(a, seeds), _serve(b, seeds)):
        assert y.self_rows.dtype == y.agg_rows.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(y.self_rows), _bits(x.self_rows))
        np.testing.assert_array_equal(_bits(y.agg_rows), _bits(x.agg_rows))
        np.testing.assert_array_equal(x.from_cache, y.from_cache)
    assert a.stats == b.stats
    assert a.cache.snapshot() == b.cache.snapshot() and b.cache.hits > 0


def test_f16_engine_equals_the_jax_engine():
    jx = _jax()
    feats, indptr, indices = _serving_world()
    table = feats.astype(np.float16)
    kw = dict(fanout=4, max_batch=4, cache_capacity=8, sample_seed=5)
    a = jx.ServingEngine(table, indptr, indices, impl="pallas",
                         clock=_fake_clock(), **kw)
    b = ServingEngine(table, indptr, indices, impl="kernel", device="cpu",
                      clock=_fake_clock(), **kw)
    assert b.feat_dtype == np.float16 and b.feats.dtype == torch.float16
    seeds = _seeds()
    for x, y in zip(_serve(a, seeds), _serve(b, seeds)):
        assert y.self_rows.dtype == y.agg_rows.dtype == np.float16
        np.testing.assert_array_equal(y.self_rows, x.self_rows)
        np.testing.assert_array_equal(y.agg_rows, x.agg_rows)
    assert a.stats == b.stats


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fetch_callable_counts_one_drain_without_touching_the_engine(dtype):
    """``fetch_callable`` hands out the fused fetch of the pending drain:
    run under the counters it counts JAX's finds, reductions and kernel
    scatters, its rows are JAX's, and the queue, the cache and the stats
    are as they were."""
    jx = _jax()
    feats, indptr, indices = _serving_world()
    tt, jt = (_t(feats), feats) if dtype == "f32" else _narrow(feats)
    a = jx.ServingEngine(np.asarray(jt), indptr, indices, impl="pallas",
                         fanout=4, max_batch=8, cache_capacity=8,
                         clock=_fake_clock())
    b = _engine(tt, indptr, indices, max_batch=8)
    for eng in (a, b):
        eng.submit([1, 2])
        eng.flush()                      # seeds 1 and 2 are now cached
        for s in range(4):
            eng.submit([s, s + 5], tenant=s)
    jfn, jargs = a.fetch_callable()
    with jx.gas.count_dispatches() as jc:
        want = jfn(*jargs)
    snap, stats = b.cache.snapshot(), dict(b.stats)
    fn, args = b.fetch_callable()
    with gas.count_dispatches() as c, \
            collectives.count_collectives() as cc:
        got = fn(*args)
    assert dict(c) == dict(jc) == {"find": 1, "reduce": 4,
                                   "kernel_scatter": 4}
    assert cc.as_dict() == {}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_f32(g), _f32(w))
    assert b.cache.snapshot() == snap and b.stats == stats
    assert len(b.queue) == 4
    with pytest.raises(ValueError, match="nothing pending"):
        b.fetch_callable([])


# ---------------------------------------------------------------------------
# the graph half's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [False, True])
def test_coo_helpers_equal_jax(weights):
    jx = _jax()
    rng = np.random.default_rng(8)
    V, E = 40, 300
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    w = rng.standard_normal(E).astype(np.float32) if weights else None
    feats = rng.standard_normal((V, 3)).astype(np.float32)
    a = jx.structure.COOGraph(V, src, dst, w, feats)
    b = COOGraph(V, src, dst, w, feats)
    np.testing.assert_array_equal(b.degree_out(), a.degree_out())
    np.testing.assert_array_equal(b.degree_in(), a.degree_in())
    assert b.degree_in().sum() == E
    for ga, gb in ((a.sort_by_dst(), b.sort_by_dst()),
                   (a.undirected(), b.undirected())):
        np.testing.assert_array_equal(gb.src, ga.src)
        np.testing.assert_array_equal(gb.dst, ga.dst)
        assert gb.src.dtype == gb.dst.dtype == np.int32
        if weights:
            np.testing.assert_array_equal(gb.weights, ga.weights)
        else:
            assert gb.weights is None
        assert gb.features is feats
    s = b.sort_by_dst()
    assert (np.diff(s.dst) >= 0).all()
    # stable: equal destinations keep their input order
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(s.src, src[order])
    u = b.undirected()
    assert u.n_edges == 2 * E
    np.testing.assert_array_equal(u.degree_out(),
                                  b.degree_out() + b.degree_in())


@pytest.mark.parametrize("F", [24, 80])
def test_feat_skip_stats(F):
    """Equal to JAX's where F ≤ 32 (one feature block on both sides); at
    wider F the port counts its own 32-feature blocks."""
    jx = _jax()
    rng = np.random.default_rng(9)
    E, n = 900, 260
    dst = np.sort(rng.integers(0, n, E)).astype(np.int32)
    vals = rng.standard_normal((E, F)).astype(np.float32)
    vals[256:640] = 0.0                      # three whole tiles
    vals[:, 40:] = 0.0                       # and whole feature blocks
    sched = ops.schedule_edges(_t(dst), None, n)
    live, band = ops.feat_skip_stats(sched, _t(vals))
    n_blocks = -(-F // 32)
    tiles = sched.work[:, 1][sched.work[:, 2] == 1].numpy()
    assert band == len(tiles) * n_blocks
    padded = np.zeros((-(-E // 128) * 128, n_blocks * 32), np.float32)
    padded[:E, :F] = vals
    per_tile = (padded.reshape(-1, 128, n_blocks, 32) != 0).any(axis=(1, 3))
    assert live == int(per_tile[tiles].sum()) < band
    if F <= 32:
        jsched = jx.ops.schedule_edges(jx.jnp.asarray(dst), None, n)
        assert (live, band) == jx.ops.feat_skip_stats(
            jsched, jx.jnp.asarray(vals), interpret=True)


# ---------------------------------------------------------------------------
# a 2-rank gloo mesh (the ranks import torch and repro_torch only)
# ---------------------------------------------------------------------------

# (dataflow, wire, features) of the sharded aggregate_multi runs
MESH_RUNS = (("cgtrans", "f32", "dense"), ("cgtrans", "bf16", "dense"),
             ("cgtrans", "int8", "dense"), ("cgtrans", "f32", "sparse"),
             ("baseline", "f32", "dense"), ("baseline", "f32", "sparse"))
DRAIN_N = 4


def _counted(fn):
    with collectives.count_collectives() as c, gas.count_dispatches() as d:
        out = fn()
    return (out, {**c.as_dict(), **{k: v for k, v in d.items() if v}},
            dict(c.bytes))


def _drain_requests(eng):
    for s in range(DRAIN_N):
        eng.submit([s, s + 1], tenant=s)


def _bf16_rank(mesh, world, serving):
    r = mesh.rank
    mine = lambda x: _t(x[r:r + 1])  # noqa: E731
    table = mine(world["sparse"]).to(torch.bfloat16)
    blocks = [(mine(n), mine(m)) for n, m in world["blocks"]]
    out = {}
    for flow, wire, feats_mode in MESH_RUNS:
        for op in ("add", "max"):
            outs, counts, _ = _counted(lambda: cgtrans.aggregate_multi(
                table, blocks, mesh=mesh, dataflow=flow, op=op,
                impl="kernel", wire=wire, features=feats_mode,
                sparse_capacity=(world["cap"] if feats_mode == "sparse"
                                 else None)))
            out[("multi", flow, wire, feats_mode, op)] = (
                [o.float().numpy() for o in outs],
                {str(o.dtype) for o in outs}, counts)
    feats, indptr, indices = serving
    bf16 = _t(feats).to(torch.bfloat16)
    for impl, scheduled in (("kernel", True), ("kernel", False),
                            ("ref", None)):
        eng = _engine(bf16, indptr, indices, mesh=mesh, impl=impl,
                      scheduled=scheduled)
        out[("engine", impl, scheduled)] = [
            (x.self_rows, x.agg_rows, x.from_cache)
            for x in _serve(eng, _seeds())]
    for name, t in (("f32", _t(feats)), ("bf16", bf16)):
        eng = _engine(t, indptr, indices, mesh=mesh, max_batch=8)
        _drain_requests(eng)
        fn, args = eng.fetch_callable()
        _, fetch_counts, _ = _counted(lambda: fn(*args))
        _, counts, nbytes = _counted(eng.flush)
        out[("drain", name)] = (fetch_counts, counts, nbytes)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "repro", "ml_dtypes"))
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    world = _agg_world()
    serving = _serving_world()
    ranks = meshlib.spawn(_bf16_rank, 2, backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S, args=(world, serving))
    return world, serving, ranks


@pytest.mark.parametrize("flow,wire,features", MESH_RUNS)
@pytest.mark.parametrize("op", ["add", "max"])
def test_sharded_aggregate_multi_on_a_bf16_table(mesh_runs, flow, wire,
                                                 features, op):
    """Each rank's slice equals the unsharded port's (itself JAX's, above):
    bit for bit on the f32 wire (the table's own bf16 ships unencoded), the
    lossless bf16 wire and sparse features; the int8 wire within 2 % of the
    span. The results stay bf16, with the f32 table's collectives."""
    world, _, ranks = mesh_runs
    table = _t(world["sparse"]).to(torch.bfloat16)
    want = cgtrans.aggregate_multi(
        table, [(_t(n), _t(m)) for n, m in world["blocks"]], op=op,
        impl="kernel", dataflow=flow)
    budget = {**budgets.held(budgets.MULTI_FWD[flow]),
              "kernel_scatter": budgets.MULTI_FWD[flow]["reduce"]}
    for r, res in enumerate(ranks):
        got, dtypes, counts = res[("multi", flow, wire, features, op)]
        assert dtypes == {"torch.bfloat16"}
        for g, w in zip(got, want):
            w = w[r:r + 1].float().numpy()
            if wire == "int8":
                assert np.abs(g - w).max() <= 0.02 * np.abs(w).max() + 1e-6
            else:
                np.testing.assert_array_equal(g, w)
        assert counts == budget
    assert ranks[0]["modules"] == ranks[1]["modules"] == []


@pytest.mark.parametrize("impl,scheduled", [("kernel", True),
                                            ("kernel", False), ("ref", None)])
def test_sharded_bf16_engine_equals_the_unsharded_engine(mesh_runs, impl,
                                                         scheduled):
    _, serving, ranks = mesh_runs
    feats, indptr, indices = serving
    eng = _engine(_t(feats).to(torch.bfloat16), indptr, indices, impl=impl,
                  scheduled=scheduled)
    want = _serve(eng, _seeds())
    for res in ranks:
        got = res[("engine", impl, scheduled)]
        assert len(got) == len(want)
        for (s, a, hit), w in zip(got, want):
            assert s.dtype == a.dtype == torch.bfloat16
            assert torch.equal(s, w.self_rows) and torch.equal(a, w.agg_rows)
            np.testing.assert_array_equal(hit, w.from_cache)


def test_sharded_bf16_drain_counts_and_bytes(mesh_runs):
    """One drain's collectives equal the budget for either table dtype, and
    its bytes ``budgets.drain_bytes``: the bf16 table's partials and
    answers take half the f32 table's bytes, its request ids the same."""
    _, serving, ranks = mesh_runs
    F = serving[0].shape[1]
    want = {**budgets.SERVE_FETCH_COLLECTIVES["fused"],
            "result_gather": budgets.RESULT_GATHER_PER_DRAIN}
    fetch = {**budgets.SERVE_FETCH_COLLECTIVES["fused"], "find": 1,
             "reduce": DRAIN_N, "kernel_scatter": DRAIN_N}
    # per rank and request: a (1, 1) lookup and a (1, 4) fan-out segment
    ids, rows = DRAIN_N * (1 + 4), DRAIN_N * 2
    for res in ranks:
        got = {}
        for name, size in (("f32", 4), ("bf16", 2)):
            fetch_counts, counts, nbytes = res[("drain", name)]
            assert fetch_counts == fetch
            assert {k: counts[k] for k in want} == want
            assert nbytes == budgets.drain_bytes(2, ids, rows, F, size,
                                                 "add")
            got[name] = nbytes
        assert got["bf16"]["all_gather"] == got["f32"]["all_gather"]
        for k in ("all_to_all", "result_gather"):
            assert 2 * got["bf16"][k] == got["f32"][k]
