"""Port parity: the serving engine.

The port's ``ServingEngine(impl="kernel", device="cpu")`` and the JAX
package's ``ServingEngine(impl="pallas")``, given the same table, CSR,
``sample_seed``, injected clock and submit sequence, must return identical
``ServeResult``s and identical dispatch statistics.
"""

import numpy as np
import pytest
import torch

from repro.graph import uniform_graph as j_uniform
from repro.serving import ServingEngine as JServingEngine
from repro_torch.core.sparse import sparse_fits
from repro_torch.launch.serve import replay_traffic
from repro_torch.serving import ServingEngine

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

V, F = 96, 12


def _fake_clock(step=0.001):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def _world():
    g = j_uniform(V, 5 * V, seed=3)
    indptr, indices, _ = g.to_csr()
    feats = np.random.default_rng(0).integers(-5, 6, (V, F)).astype(
        np.float32)
    return feats, indptr, indices


def _serve(eng, seeds_list):
    rids = [eng.submit(s, tenant=j % 3) for j, s in enumerate(seeds_list)]
    # a mid-stream poll exercises the size trigger; flush drains the rest
    eng.poll()
    eng.flush()
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("cache,fuse,scheduled,op", [
    (0, True, True, "add"),
    (8, True, True, "max"),
    (8, False, True, "add"),
    (0, True, False, "max"),
    (8, True, False, "add"),
    (0, False, False, "max"),
])
def test_engine_equals_reference(cache, fuse, scheduled, op):
    feats, indptr, indices = _world()
    kw = dict(fanout=4, op=op, max_batch=4, cache_capacity=cache, fuse=fuse,
              scheduled=scheduled, sample_seed=5)
    a = JServingEngine(feats, indptr, indices, impl="pallas",
                       clock=_fake_clock(), **kw)
    b = ServingEngine(feats, indptr, indices, impl="kernel", device="cpu",
                      clock=_fake_clock(), **kw)
    rng = np.random.default_rng(1)
    hot = rng.integers(0, V, 4)
    seeds_list = [rng.choice(hot, int(rng.integers(1, 4))) for _ in range(9)]
    ra, rb = _serve(a, seeds_list), _serve(b, seeds_list)
    for x, y in zip(ra, rb):
        assert (x.rid, x.tenant) == (y.rid, y.tenant)
        np.testing.assert_array_equal(x.self_rows, y.self_rows)
        np.testing.assert_array_equal(x.agg_rows, y.agg_rows)
        np.testing.assert_array_equal(x.from_cache, y.from_cache)
    assert a.stats == b.stats
    if cache:
        assert a.cache.snapshot() == b.cache.snapshot()
        assert b.cache.hits > 0


def test_replay_traffic_serves_every_request_through_the_kernels():
    feats, indptr, indices = _world()
    eng = ServingEngine(feats, indptr, indices, fanout=4, max_batch=8,
                        cache_capacity=16, device="cpu", clock=_fake_clock())
    ref = ServingEngine(feats, indptr, indices, fanout=4, max_batch=8,
                        cache_capacity=16, device="cpu", clock=_fake_clock(),
                        impl="ref")
    rids, per_tenant = replay_traffic(eng, requests=20, tenants=4, seed=2)
    replay_traffic(ref, requests=20, tenants=4, seed=2)
    assert eng.stats["queries"] == 20 and per_tenant == [5, 5, 5, 5]
    assert eng.stats["kernel_scatter"] > 0 and ref.stats["kernel_scatter"] == 0
    for r in rids:
        x, y = eng.result(r), ref.result(r)
        np.testing.assert_array_equal(x.self_rows, y.self_rows)
        np.testing.assert_array_equal(x.agg_rows, y.agg_rows)
    snap = eng.health_snapshot()
    assert snap["monitor"]["steps"] == eng.stats["dispatches"]


def test_engine_knobs_outside_the_slice_raise():
    feats, indptr, indices = _world()
    kw = dict(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(feats, indptr, indices, mesh=object(), **kw)
    with pytest.raises(ValueError, match="unknown partition"):
        ServingEngine(feats, indptr, indices, partition="hash", **kw)
    # without a mesh the wire and sparse features are validated no-ops, on
    # a table sparse enough that the packed path really runs
    table = np.where(feats > 3, feats, 0).astype(np.float32)
    served = []
    for knobs in ({}, dict(wire="bf16"), dict(wire="int8"),
                  dict(features="sparse")):
        eng = ServingEngine(table, indptr, indices, **knobs, **kw)
        rid = eng.submit([1, 2, 3])
        eng.flush()
        served.append(eng.result(rid))
    assert eng.sparse_capacity is not None and \
        sparse_fits(eng.sparse_capacity, table.shape[1])
    for res in served[1:]:
        np.testing.assert_array_equal(res.self_rows, served[0].self_rows)
        np.testing.assert_array_equal(res.agg_rows, served[0].agg_rows)
    with pytest.raises(ValueError):
        ServingEngine(feats, indptr, indices, wire="bf16",
                      dataflow="baseline", **kw)
    # a float16 table is served in its own dtype (tests/test_torch_bf16.py)
    assert ServingEngine(feats.astype(np.float16), indptr, indices,
                         **kw).feats.dtype == torch.float16
    with pytest.raises(ValueError):
        ServingEngine(feats, indptr, indices, impl="pallas", **kw)
    eng = ServingEngine(feats.astype(np.int64), indptr, indices, **kw)
    assert eng.feats.dtype == torch.float32
    assert eng.impl == "kernel"
