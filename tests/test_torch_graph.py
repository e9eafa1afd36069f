"""Port parity: host-side graph generation, CSR, sampling and batches.

These modules are numpy in both packages, so the same seed must give the
same arrays, element for element.
"""

import numpy as np
import pytest
import torch

from repro.data.pipeline import GraphBatchStream as JGraphBatchStream
from repro.data.pipeline import synthetic_node_labels as j_labels
from repro.graph import (clustered_graph as j_clustered, host_sample_csr as
                         j_sample, rmat as j_rmat, uniform_graph as j_uniform)
from repro.graph.structure import COOGraph as JCOOGraph
from repro_torch.data import GraphBatchStream, synthetic_node_labels
from repro_torch.graph import (COOGraph, clustered_graph, host_sample_csr,
                               rmat, uniform_graph)

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def _same_graph(a, b):
    assert a.n_vertices == b.n_vertices
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    for x, y in ((a.weights, b.weights), (a.features, b.features)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.to_csr(), b.to_csr()):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("V,E,seed,n_features,weights", [
    (64, 300, 0, 0, False), (100, 50, 3, 8, True), (1, 4, 1, 2, False)])
def test_uniform_graph_equals_reference(V, E, seed, n_features, weights):
    _same_graph(j_uniform(V, E, seed=seed, n_features=n_features,
                          weights=weights),
                uniform_graph(V, E, seed=seed, n_features=n_features,
                              weights=weights))


@pytest.mark.parametrize("V,C,p_intra", [(101, 8, 0.9), (5, 8, 0.5),
                                         (64, 4, 1.0)])
def test_clustered_graph_equals_reference(V, C, p_intra):
    _same_graph(j_clustered(V, 7 * V, n_clusters=C, p_intra=p_intra, seed=2,
                            n_features=3, weights=True),
                clustered_graph(V, 7 * V, n_clusters=C, p_intra=p_intra,
                                seed=2, n_features=3, weights=True))


@pytest.mark.parametrize("scale,weights", [(5, False), (7, True)])
def test_rmat_equals_reference(scale, weights):
    _same_graph(j_rmat(scale, 4, seed=scale, weights=weights),
                rmat(scale, 4, seed=scale, weights=weights))


def test_weighted_csr_equals_reference():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 20, 60).astype(np.int64)
    dst = rng.integers(0, 20, 60).astype(np.int64)
    w = rng.random(60).astype(np.float32)
    a, b = JCOOGraph(20, src, dst, w), COOGraph(20, src, dst, w)
    assert b.src.dtype == np.int32 and b.n_edges == a.n_edges == 60
    _same_graph(a.sort_by_src(), b.sort_by_src())


def _sparse_graph():
    """A graph where about half the vertices have no out-edges."""
    g = uniform_graph(40, 25, seed=5)
    return g, g.to_csr()


@pytest.mark.parametrize("fanout,seed", [(1, 0), (5, 3), (50, 11)])
def test_host_sample_csr_equals_reference_with_isolated(fanout, seed):
    g, (indptr, indices, _) = _sparse_graph()
    seeds = np.arange(g.n_vertices, dtype=np.int32)
    n_a, m_a = j_sample(indptr, indices, seeds, fanout, seed=seed)
    n_b, m_b = host_sample_csr(indptr, indices, seeds, fanout, seed=seed)
    np.testing.assert_array_equal(n_a, n_b)
    np.testing.assert_array_equal(m_a, m_b)
    isolated = np.diff(indptr) == 0
    assert isolated.any()
    # an isolated vertex samples itself, and those samples are valid
    np.testing.assert_array_equal(n_b[isolated],
                                  np.repeat(seeds[isolated, None], fanout, 1))
    assert m_b.all()


@pytest.mark.parametrize("P,B,k1,k2", [(1, 4, 3, 4), (2, 3, 5, 2)])
def test_graph_batch_stream_equals_reference(P, B, k1, k2):
    g, _ = _sparse_graph()
    labels = np.arange(g.n_vertices, dtype=np.int32) % 5
    a = JGraphBatchStream(JCOOGraph(g.n_vertices, g.src, g.dst), labels, P,
                          B, k1=k1, k2=k2, seed=7)
    b = GraphBatchStream(g, labels, P, B, k1=k1, k2=k2, seed=7)
    for step in (0, 1, 5):
        ba, bb = a.batch_at(step), b.batch_at(step)
        assert ba.keys() == bb.keys()
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])


def test_synthetic_node_labels_equal_reference():
    feats = np.random.default_rng(1).standard_normal((50, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(j_labels(feats, 7, seed=4),
                                  synthetic_node_labels(feats, 7, seed=4))


# ---------------------------------------------------------------------------
# Table II graphs, host_sample and the device sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Reddit", "Movielens", "Amazon",
                                  "OGBN-100M", "Protein-PI"])
def test_table2_like_equals_reference(name):
    from repro.graph import TABLE_II as J_TABLE_II
    from repro.graph import table2_like as j_table2_like
    from repro_torch.graph import TABLE_II, table2_like

    assert TABLE_II[name] == J_TABLE_II[name]
    _same_graph(j_table2_like(name, scale_down=1e6, seed=3),
                table2_like(name, scale_down=1e6, seed=3))


@pytest.mark.parametrize("fanout,seed", [(1, 0), (7, 2)])
def test_host_sample_equals_reference(fanout, seed):
    from repro.graph import host_sample as j_host_sample
    from repro_torch.graph import host_sample

    g, _ = _sparse_graph()
    seeds = np.random.default_rng(seed).integers(0, g.n_vertices, 30)
    jg = JCOOGraph(g.n_vertices, g.src, g.dst)
    for a, b in zip(j_host_sample(jg, seeds, fanout, seed=seed),
                    host_sample(g, seeds, fanout, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_fanout_offsets_equal_reference_on_identical_draws():
    """The same float32 draws give the reference's offsets, including u =
    1.0 and u just below 1.0, where the unclamped product lands on deg."""
    import jax.numpy as jnp

    from repro.graph.sampling import _fanout_offsets as j_offsets
    from repro_torch.graph.sampling import _fanout_offsets

    degs = np.asarray([0, 1, 3, 7, 50, 1 << 20, (1 << 24) + 1], np.int32)
    rng = np.random.default_rng(0)
    draws = [rng.random((degs.size, 16)).astype(np.float32)]
    for u in (1.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 0.0):
        draws.append(np.full((degs.size, 4), u, np.float32))
    for u in draws:
        got = _fanout_offsets(torch.from_numpy(u), torch.from_numpy(degs))
        want = np.asarray(j_offsets(jnp.asarray(u), jnp.asarray(degs)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy() < np.maximum(degs, 1)[:, None]).all()
        assert (got.numpy() >= 0).all()


def test_device_sampler_semantics():
    """The reference's contract: every sample valid, an isolated vertex
    fills its fan-out with itself, samples are real neighbors, the next
    vertex's slot is never read; the result lives where the tensors do."""
    from repro_torch.graph import device_sample

    g, (indptr, indices, _) = _sparse_graph()
    seeds = np.arange(g.n_vertices, dtype=np.int32)
    gen = torch.Generator().manual_seed(0)
    nbrs, mask = device_sample(torch.from_numpy(indptr),
                               torch.from_numpy(indices),
                               torch.from_numpy(seeds), 9, gen)
    assert nbrs.dtype == torch.int32 and nbrs.device.type == "cpu"
    assert mask.all() and nbrs.shape == (g.n_vertices, 9)
    for s in seeds:
        real = set(indices[indptr[s]:indptr[s + 1]].tolist())
        row = set(nbrs[s].tolist())
        assert row <= real if real else row == {int(s)}
    # vertex 0's neighbors are all 0; vertex 1's single neighbor is the
    # sentinel 1, right after 0's range
    two = COOGraph(2, np.asarray([0] * 37 + [1], np.int32),
                   np.asarray([0] * 37 + [1], np.int32))
    ip, ix, _ = two.to_csr()
    for k in range(4):
        n, m = device_sample(torch.from_numpy(ip), torch.from_numpy(ix),
                             torch.zeros(1, dtype=torch.int32), 64,
                             torch.Generator().manual_seed(k))
        assert m.all() and (n == 0).all()
    # and an edgeless graph self-aggregates every seed
    n, m = device_sample(torch.zeros(4, dtype=torch.int64),
                         torch.zeros(0, dtype=torch.int32),
                         torch.arange(3, dtype=torch.int32), 2,
                         torch.Generator())
    assert m.all() and torch.equal(n, torch.arange(3, dtype=torch.int32)[
        :, None].expand(3, 2))
