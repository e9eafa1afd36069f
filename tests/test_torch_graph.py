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
