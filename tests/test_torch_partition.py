"""Port parity: vertex-interval partitioning (``graph/partition.py``).

The port's numpy copy must cut every graph where the JAX package cuts it:
``interval_size``, ``partition_by_src`` (local src ids, global dst ids,
weights, padding mask, the owner-sharded feature table),
``partition_graph`` (interval and island) and ``remote_destination_rows``
equal the reference array for array.
"""

import numpy as np
import pytest
import torch

from repro.graph import partition as jpart
from repro.graph.structure import COOGraph as JCOOGraph
from repro_torch import graph as tgraph
from repro_torch.graph.structure import COOGraph

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def _graphs(V, E, seed, weights, n_features):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.random(E).astype(np.float32) + 0.05 if weights else None
    f = (rng.standard_normal((V, n_features)).astype(np.float32)
         if n_features else None)
    return JCOOGraph(V, src, dst, w, f), COOGraph(V, src, dst, w, f)


def _same(a, b):
    assert (a.n_vertices, a.n_parts, a.part_size, a.e_max) == \
        (b.n_vertices, b.n_parts, b.part_size, b.e_max)
    for k in ("src", "dst", "weights", "mask"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    if a.features is None:
        assert b.features is None
    else:
        np.testing.assert_array_equal(a.features, b.features)


@pytest.mark.parametrize("V,P,pad", [(1, 1, 8), (100, 3, 8), (256, 8, 8),
                                     (1000, 7, 1), (1 << 20, 4, 8),
                                     (5, 8, 8)])
def test_interval_size_equals_reference(V, P, pad):
    assert tgraph.interval_size(V, P, pad_multiple=pad) == \
        jpart.interval_size(V, P, pad_multiple=pad)


@pytest.mark.parametrize("V,E,P,pad,weights,n_features", [
    (64, 512, 2, 8, False, 8),
    (100, 700, 3, 8, True, 0),
    (256, 2048, 8, 8, True, 5),
    (37, 90, 4, 1, False, 3),
    (16, 0, 2, 8, False, 0),
])
def test_partition_by_src_equals_reference(V, E, P, pad, weights,
                                           n_features):
    jg, tg = _graphs(V, E, V + E, weights, n_features)
    want = jpart.partition_by_src(jg, P, pad_multiple=pad)
    got = tgraph.partition_by_src(tg, P, pad_multiple=pad)
    _same(want, got)
    np.testing.assert_array_equal(tgraph.remote_destination_rows(got),
                                  jpart.remote_destination_rows(want))


def test_partition_graph_equals_reference_for_interval_and_island():
    jg, tg = _graphs(120, 900, 5, True, 4)
    want, jisl = jpart.partition_graph(jg, 4)
    got, isl = tgraph.partition_graph(tg, 4)
    assert jisl is None and isl is None
    _same(want, got)
    want, jisl = jpart.partition_graph(jg, 4, method="island")
    got, isl = tgraph.partition_graph(tg, 4, method="island")
    _same(want, got)
    np.testing.assert_array_equal(isl.relabel, jisl.relabel)
    with pytest.raises(ValueError):
        tgraph.partition_graph(tg, 4, method="metis")


def test_partitioned_table_is_the_sharded_feature_table():
    """``feature_table(mesh=)`` cuts the table where ``partition_by_src``
    does: rank r's slice is ``features[r]``."""
    from repro_torch.core.gcn import feature_table
    from repro_torch.launch.mesh import DataMesh

    jg, tg = _graphs(100, 300, 2, False, 6)
    pg = jpart.partition_by_src(jg, 3)
    for r in range(3):
        mesh = DataMesh(None, r, 3, torch.device("cpu"), "gloo")
        got = feature_table(tg.features, 3, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(got.numpy(), pg.features[r:r + 1])
