"""Port parity: the paper's cost model (``core/cost_model.py``).

A numpy copy of the JAX package's module, reading the port's own
``TABLE_II``: every output of ``fig15_table``, ``fig14_area``,
``fig16c_breakdown``, ``latency``, ``load_bytes``, ``request_bytes`` and
``simulate_gas_traversal`` equals the reference's with ``==`` (the same
numpy and float operations in the same order). The traversal levels come
from the port's BFS on the GAS engine, and equal a host BFS.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro_torch.core import algorithms as alg
from repro_torch.core import cost_model as cm
from repro_torch.graph import TABLE_II, rmat

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def test_constants_and_table_are_the_reference_s():
    from repro.graph.synthetic import TABLE_II as J_TABLE_II

    assert TABLE_II == J_TABLE_II
    assert dataclasses.asdict(cm.C) == dataclasses.asdict(jcm.C)
    assert (cm.T_EDGE_CACHE_NS, cm.T_ROUND_NS) == \
        (jcm.T_EDGE_CACHE_NS, jcm.T_ROUND_NS)


@pytest.mark.parametrize("batch,fanout", [(4096, 50), (1024, 10), (64, 25)])
def test_fig15_table_equals_reference(batch, fanout):
    got = cm.fig15_table(batch=batch, fanout=fanout)
    want = jcm.fig15_table(batch=batch, fanout=fanout)
    assert got == want
    assert [r["dataset"] for r in got] == list(TABLE_II)


def test_fig15_headline():
    """The figures ``examples/quickstart.py`` prints: ~50× loading cut,
    ~3.6× over GCNAX and ~2.4× over Insider, averaged."""
    rows = cm.fig15_table()
    mean = lambda k: float(np.mean([r[k] for r in rows]))  # noqa: E731
    assert mean("load_reduction") == 50.0
    assert 3.0 < mean("speedup_vs_gcnax") < 4.2
    assert 2.0 < mean("speedup_vs_insider") < 2.8


@pytest.mark.parametrize("cache_mb", [0.5, 1.0, 4.0])
def test_fig14_area_equals_reference(cache_mb):
    assert cm.fig14_area(cache_mb=cache_mb) == jcm.fig14_area(
        cache_mb=cache_mb)


def test_fig16c_breakdown_equals_reference():
    assert cm.fig16c_breakdown() == jcm.fig16c_breakdown()


@pytest.mark.parametrize("system", ["gcnax", "insider", "graphic"])
@pytest.mark.parametrize("F", [32, 602, 1000])
def test_latency_and_bytes_equal_reference(system, F):
    w, jw = (m.SageWorkload(batch=512, fanout=50, n_features=F, hidden=128)
             for m in (cm, jcm))
    for mb in (0.25, 1.0, 8.0):
        assert cm.latency(w, system, cache_mb=mb) == jcm.latency(
            jw, system, cache_mb=mb)
    for flow in ("baseline", "cgtrans"):
        assert cm.load_bytes(w, cm.C, flow) == jcm.load_bytes(jw, jcm.C,
                                                              flow)
    assert cm.request_bytes(w, cm.C) == jcm.request_bytes(jw, jcm.C)
    assert (cm.agg_ops(w), cm.comb_macs(w)) == (jcm.agg_ops(jw),
                                                jcm.comb_macs(jw))
    for engine in ("gas", "insider", "digital"):
        assert cm.C.agg_ops_per_s(engine, 2.0) == jcm.C.agg_ops_per_s(
            engine, 2.0)


def _host_bfs(indptr, indices, n, src=0):
    lev = np.full(n, -1, np.int64)
    lev[src] = 0
    frontier, d = [src], 0
    while frontier:
        nxt = []
        for v in frontier:
            for u in indices[indptr[v]:indptr[v + 1]]:
                if lev[u] < 0:
                    lev[u] = d + 1
                    nxt.append(u)
        frontier, d = nxt, d + 1
    return lev


@pytest.mark.parametrize("scale,cache_mb", [(9, 1.0), (10, 0.25),
                                            (10, 4.0)])
def test_simulate_gas_traversal_equals_reference(scale, cache_mb):
    """Levels from the port's BFS (``impl="kernel"``, the dense grid's
    plain version here), equal to a host BFS, feed both models."""
    g = rmat(scale, 16, seed=3)
    indptr, indices, _ = g.to_csr()
    lev = alg.bfs(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                  g.n_vertices, 0, impl="kernel").numpy()
    levels = np.where(np.isfinite(lev), lev, -1).astype(np.int64)
    np.testing.assert_array_equal(levels, _host_bfs(indptr, indices,
                                                    g.n_vertices))
    got = cm.simulate_gas_traversal(indptr, levels, cache_mb=cache_mb)
    want = jcm.simulate_gas_traversal(indptr, levels, cache_mb=cache_mb)
    assert got == want
