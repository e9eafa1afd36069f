"""Port parity: the paper's graph algorithms on the GAS engine
(``core/algorithms.py``).

The same numpy graphs go through the JAX package's ``impl="xla"`` and the
port's ``impl="ref"`` and ``impl="kernel"`` (the dense grid's plain
version here on the CPU): BFS levels, SSSP distances and CC labels bit
for bit on R-MAT and uniform graphs, ``gas_sort`` exact with ties, and
``feature_embedding`` exact on integer data. The port's dispatch counter
counts a traversal's loop body once, as the JAX trace counts its
``while_loop`` body.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import algorithms as jalg
from repro.core import gas as jgas
from repro_torch.core import algorithms as alg
from repro_torch.core import gas
from repro_torch.graph import rmat, uniform_graph

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

IMPLS = ("ref", "kernel")

_GRAPHS = {
    "rmat-7": lambda: rmat(7, 8, seed=1, weights=True),
    "rmat-8": lambda: rmat(8, 4, seed=2, weights=True),
    "uniform-90": lambda: uniform_graph(90, 300, seed=3, weights=True),
    "uniform-sparse": lambda: uniform_graph(100, 120, seed=2, weights=True),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_bfs_sssp_cc_equal_reference(name, impl):
    g = _GRAPHS[name]()
    V = g.n_vertices
    src = int(np.bincount(g.src, minlength=V).argmax())   # a hub
    got = alg.bfs(_t(g.src), _t(g.dst), V, src, impl=impl)
    want = jalg.bfs(_j(g.src), _j(g.dst), V, src)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).sum() > 1              # it went somewhere
    got = alg.sssp(_t(g.src), _t(g.dst), _t(g.weights), V, src, impl=impl)
    want = jalg.sssp(_j(g.src), _j(g.dst), _j(g.weights), V, src)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32
    got = alg.connected_components(_t(g.src), _t(g.dst), V, impl=impl)
    want = jalg.connected_components(_j(g.src), _j(g.dst), V)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_max_iters_stops_where_the_reference_stops(max_iters):
    g = rmat(7, 4, seed=5, weights=True)
    V = g.n_vertices
    for impl in IMPLS:
        got = alg.sssp(_t(g.src), _t(g.dst), _t(g.weights), V, 0, impl=impl,
                       max_iters=max_iters)
        want = jalg.sssp(_j(g.src), _j(g.dst), _j(g.weights), V, 0,
                         max_iters=max_iters)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = alg.connected_components(_t(g.src), _t(g.dst), V, impl=impl,
                                       max_iters=max_iters)
        want = jalg.connected_components(_j(g.src), _j(g.dst), V,
                                         max_iters=max_iters)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,ties", [(1, False), (100, False), (257, True),
                                    (64, True)])
def test_gas_sort_equals_reference(n, ties, impl):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    if ties:
        x[::3] = x[0]
        x[1::5] = -2.5
    got = alg.gas_sort(_t(x), impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jalg.gas_sort(
        _j(x))))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_feature_embedding_equals_reference_on_integer_data(op, impl):
    g = rmat(7, 8, seed=4)
    rng = np.random.default_rng(7)
    w = rng.integers(-2, 3, g.n_edges).astype(np.float32)
    feats = rng.integers(-4, 5, (g.n_vertices, 40)).astype(np.float32)
    got = alg.feature_embedding(_t(g.src), _t(g.dst), _t(w), _t(feats),
                                op=op, impl=impl)
    want = jalg.feature_embedding(_j(g.src), _j(g.dst), _j(w), _j(feats),
                                  op=op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_counts_tick_once_per_round(monkeypatch):
    """The port counts each traversal's loop body once, as the JAX trace
    counts its ``while_loop`` body: one ``find`` and, on the kernel route,
    one ``kernel_scatter``, whatever the number of rounds. Every round
    still runs its scatter (counted here by wrapping it), and the rounds
    are the fixed point's."""
    g = rmat(7, 8, seed=1, weights=True)
    V = g.n_vertices
    calls = []

    def scatter(*args, **kwargs):
        calls.append(kwargs["impl"])
        return gas.gas_scatter(*args, **kwargs)

    monkeypatch.setattr(alg, "gas_scatter", scatter)
    traversals = {
        "bfs": (lambda impl: alg.bfs(_t(g.src), _t(g.dst), V, 0, impl=impl),
                lambda impl: jalg.bfs(_j(g.src), _j(g.dst), V, 0, impl=impl)),
        "sssp": (lambda impl: alg.sssp(_t(g.src), _t(g.dst), _t(g.weights),
                                       V, 0, impl=impl),
                 lambda impl: jalg.sssp(_j(g.src), _j(g.dst),
                                        _j(g.weights), V, 0, impl=impl)),
        "cc": (lambda impl: alg.connected_components(_t(g.src), _t(g.dst), V,
                                                     impl=impl),
               lambda impl: jalg.connected_components(_j(g.src), _j(g.dst), V,
                                                      impl=impl)),
    }
    rounds = {}
    for name, (port, ref) in traversals.items():
        for impl, jimpl in (("ref", "xla"), ("kernel", "pallas")):
            calls.clear()
            with gas.count_dispatches() as c:
                port(impl)
            with jgas.count_dispatches() as jc:
                ref(jimpl)
            assert (c["find"], c["kernel_scatter"]) == \
                (jc["find"], jc["kernel_scatter"]) == \
                (1, 1 if impl == "kernel" else 0), (name, impl)
            rounds[name, impl] = len(calls)
        assert rounds[name, "ref"] == rounds[name, "kernel"] > 2, name
    # the rounds are the fixed point's: one more round changes nothing,
    # one fewer leaves a distance to fall
    n = rounds["sssp", "ref"]
    full = alg.sssp(_t(g.src), _t(g.dst), _t(g.weights), V, 0)
    short = alg.sssp(_t(g.src), _t(g.dst), _t(g.weights), V, 0,
                     max_iters=n - 2)
    assert torch.equal(alg.sssp(_t(g.src), _t(g.dst), _t(g.weights), V, 0,
                                max_iters=n - 1), full)
    assert not torch.equal(short, full)


def test_results_stay_on_the_edges_device():
    """The algorithms take their device from the edge tensors."""
    g = uniform_graph(20, 60, seed=0, weights=True)
    for out in (alg.bfs(_t(g.src), _t(g.dst), 20, 0),
                alg.connected_components(_t(g.src), _t(g.dst), 20),
                alg.gas_sort(_t(g.weights))):
        assert out.device == torch.device("cpu")
