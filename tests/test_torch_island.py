"""Port parity: islandized locality partitioning (``partition="island"``).

* ``islandize`` / ``relabel_graph`` / ``partition_graph(method="island")``
  give the JAX package's ``relabel``, ``inverse``, ``island_of``,
  ``n_islands`` and partitioned arrays exactly, on shuffled clustered
  graphs and a uniform graph, for P in {1, 2, 4, 8};
* copies of the reference's invariant tests (``tests/test_partition.py``):
  a permutation, deterministic, capacity-capped and interval-aligned,
  structure kept, remote rows and dense occupancy shrink;
* islandized ≡ interval unsharded, in the port and in the JAX package on
  the same inputs: ``gcn_forward_full`` values and parameter gradients on
  integer data after the un-permute, ``sage_forward``, one
  ``make_sage_train_step`` step and the serving engine with the hot cache
  on — bit for bit, on both GAS routes.

The sharded cases run on gloo ranks in ``tests/test_torch_dist_edges.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.graph import COOGraph as JCOOGraph
from repro.graph import partition as jpart
from repro_torch.graph import (COOGraph, clustered_graph, interval_size,
                               islandize, partition_by_src, partition_graph,
                               relabel_graph, remote_destination_rows,
                               uniform_graph)

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

IMPLS = ("ref", "kernel")
JIMPL = {"ref": "xla", "kernel": "pallas"}


def _shuffled_clustered(V, E, *, n_clusters, p_intra, seed, **kw):
    """A community graph whose vertex ids are scrambled (the reference
    tests' ``_shuffled_clustered``), built by the port's generator."""
    g = clustered_graph(V, E, n_clusters=n_clusters, p_intra=p_intra,
                        seed=seed, **kw)
    perm = np.random.default_rng(seed + 1000).permutation(V).astype(np.int32)
    feats = None if g.features is None else g.features[np.argsort(perm)]
    return COOGraph(V, perm[g.src], perm[g.dst], g.weights, feats)


def _jax_graph(g):
    return JCOOGraph(g.n_vertices, g.src, g.dst, g.weights, g.features)


# ---------------------------------------------------------------------------
# islandize against the reference
# ---------------------------------------------------------------------------

_GRAPHS = {
    "clustered-200": lambda: _shuffled_clustered(200, 1600, n_clusters=8,
                                                 p_intra=0.9, seed=2),
    "clustered-300": lambda: _shuffled_clustered(300, 2400, n_clusters=10,
                                                 p_intra=0.9, seed=5,
                                                 n_features=3, weights=True),
    "clustered-150": lambda: _shuffled_clustered(150, 900, n_clusters=6,
                                                 p_intra=0.85, seed=7),
    "uniform-160": lambda: uniform_graph(160, 700, seed=4, n_features=2,
                                         weights=True),
}


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_islandize_equals_reference(name, P):
    g = _GRAPHS[name]()
    want = jpart.islandize(_jax_graph(g), P)
    got = islandize(g, P)
    assert (got.n_vertices, got.n_parts, got.part_size, got.n_islands) == \
        (want.n_vertices, want.n_parts, want.part_size, want.n_islands)
    for k in ("relabel", "inverse", "island_of"):
        x, y = getattr(got, k), getattr(want, k)
        assert x.dtype == y.dtype == np.int32, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    # the relabeled graph and the island partition, array for array
    rg, jrg = relabel_graph(g, got), jpart.relabel_graph(_jax_graph(g), want)
    for k in ("src", "dst", "weights", "features"):
        x, y = getattr(rg, k), getattr(jrg, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)
    pg, isl = partition_graph(g, P, method="island")
    jpg, _ = jpart.partition_graph(_jax_graph(g), P, method="island")
    np.testing.assert_array_equal(isl.relabel, want.relabel)
    assert pg.part_size == jpg.part_size and pg.e_max == jpg.e_max
    for k in ("src", "dst", "weights", "mask", "features"):
        x, y = getattr(pg, k), getattr(jpg, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)
    np.testing.assert_array_equal(remote_destination_rows(pg),
                                  jpart.remote_destination_rows(jpg))


@pytest.mark.parametrize("pad,refine", [(1, 2), (8, 0), (8, 5)])
def test_islandize_knobs_equal_reference(pad, refine):
    g = _shuffled_clustered(130, 1000, n_clusters=5, p_intra=0.8, seed=11)
    want = jpart.islandize(_jax_graph(g), 3, pad_multiple=pad,
                           refine_passes=refine)
    got = islandize(g, 3, pad_multiple=pad, refine_passes=refine)
    assert got.n_islands == want.n_islands
    assert got.part_size == want.part_size
    np.testing.assert_array_equal(got.relabel, want.relabel)
    np.testing.assert_array_equal(got.island_of, want.island_of)


# ---------------------------------------------------------------------------
# the reference's invariants, on the port
# ---------------------------------------------------------------------------

def test_islandize_relabel_is_permutation():
    g = _shuffled_clustered(200, 1600, n_clusters=8, p_intra=0.9, seed=2)
    isl = islandize(g, 4)
    np.testing.assert_array_equal(np.sort(isl.relabel), np.arange(200))
    np.testing.assert_array_equal(isl.relabel[isl.inverse], np.arange(200))
    np.testing.assert_array_equal(isl.inverse[isl.relabel], np.arange(200))
    assert isl.n_islands >= 1
    assert isl.island_of.min() >= 0 and isl.island_of.max() < isl.n_islands


def test_islandize_deterministic():
    g = _shuffled_clustered(150, 900, n_clusters=6, p_intra=0.85, seed=7)
    a, b = islandize(g, 4), islandize(g, 4)
    np.testing.assert_array_equal(a.relabel, b.relabel)


def test_islandize_capacity_and_interval_alignment():
    V, P = 300, 4
    g = _shuffled_clustered(V, 2400, n_clusters=10, p_intra=0.9, seed=5)
    isl = islandize(g, P)
    sizes = np.bincount(isl.island_of, minlength=isl.n_islands)
    assert sizes.max() <= isl.part_size
    assert isl.relabel.min() == 0 and isl.relabel.max() == V - 1
    assert isl.part_size == interval_size(V, P)
    assert isl.part_size == partition_by_src(g, P).part_size


def test_relabel_graph_preserves_structure():
    g = _shuffled_clustered(120, 800, n_clusters=6, p_intra=0.9, seed=9,
                            n_features=4, weights=True)
    isl = islandize(g, 4)
    rg = relabel_graph(g, isl)
    np.testing.assert_array_equal(rg.src, isl.relabel[g.src])
    np.testing.assert_array_equal(rg.dst, isl.relabel[g.dst])
    np.testing.assert_array_equal(rg.weights, g.weights)
    np.testing.assert_array_equal(rg.features[isl.relabel], g.features)
    np.testing.assert_array_equal(isl.unrelabel_rows(rg.features), g.features)
    np.testing.assert_array_equal(isl.relabel_rows(g.features), rg.features)


def test_islandize_reduces_remote_rows_and_dense_rounds():
    """The counted locality claim: on a shuffled-id clustered graph the
    islandized partition shrinks the per-shard remote destination rows
    and the dense (row block × edge tile) occupancy the port's dense grid
    walks."""
    from repro_torch.kernels.gas_scatter import ops

    g = _shuffled_clustered(1024, 8192, n_clusters=8, p_intra=0.95, seed=3)
    pg_i, _ = partition_graph(g, 8, method="interval")
    pg_s, isl = partition_graph(g, 8, method="island")
    assert isl is not None and pg_i.part_size == pg_s.part_size
    rr_i, rr_s = remote_destination_rows(pg_i), remote_destination_rows(pg_s)
    assert int(rr_s.sum()) < int(rr_i.sum())
    assert int(rr_s.max()) < int(rr_i.max())

    def dense_live(pg):
        return sum(ops.dense_skip_stats(
            torch.from_numpy(pg.dst[p]), torch.from_numpy(pg.mask[p]),
            pg.n_parts * pg.part_size)[0] for p in range(pg.n_parts))

    assert dense_live(pg_s) < dense_live(pg_i)


def test_partition_graph_unknown_method():
    g = uniform_graph(16, 32, seed=0)
    with pytest.raises(ValueError, match="unknown partition method"):
        partition_graph(g, 2, method="metis")


# ---------------------------------------------------------------------------
# islandized ≡ interval, unsharded
# ---------------------------------------------------------------------------

def _int_params(schema, rng):
    return {k: rng.integers(-2, 3, d.shape).astype(np.float32)
            for k, d in schema.items()}


def _tensors(pg):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (pg.features, pg.src, pg.dst, pg.weights, pg.mask))


@pytest.mark.parametrize("op", ["add", "max"])
def test_gcn_forward_full_island_parity_values_and_grads(op):
    """Full-graph islandized ≡ interval bit for bit on integer data, values
    and (add) parameter gradients, after the un-permute; both port routes
    equal the JAX package's, which holds the same identity. max splits a
    cotangent among tied edges in thirds, whose sums depend on the order,
    so its gradients are held within 1e-5 of max|g|."""
    import jax
    import jax.numpy as jnp

    from repro.core.gcn import GCNConfig as JGCNConfig
    from repro.core.gcn import gcn_forward_full as j_forward
    from repro_torch.core.gcn import (GCNConfig, gcn_forward_full,
                                      gcn_schema)

    rng = np.random.default_rng(0)
    V, P, F, C = 96, 4, 6, 5
    g = _shuffled_clustered(V, 768, n_clusters=8, p_intra=0.9, seed=3)
    g.features = rng.integers(-3, 4, (V, F)).astype(np.float32)
    pg_i, _ = partition_graph(g, P, method="interval")
    pg_s, isl = partition_graph(g, P, method="island")
    jcfg = JGCNConfig(n_features=F, hidden=8, n_classes=C, aggregate=op)
    params = _int_params(gcn_schema(GCNConfig(n_features=F, hidden=8,
                                              n_classes=C)), rng)

    def jrun(p, pg, relabel):
        cfg = dataclasses.replace(jcfg, partition="island" if relabel
                                  is not None else "interval")
        return j_forward(p, *(jnp.asarray(x) for x in (
            pg.features, pg.src, pg.dst, pg.weights, pg.mask)), cfg,
            relabel=relabel).reshape(-1, C)[:V]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jrun(jp, pg_i, None))
    np.testing.assert_array_equal(np.asarray(jrun(jp, pg_s, isl.relabel)),
                                  want)
    jgrad = jax.grad(lambda p: jrun(p, pg_i, None).sum())(jp)
    for impl in IMPLS:
        cfg = GCNConfig(n_features=F, hidden=8, n_classes=C, aggregate=op,
                        impl=impl)
        outs, grads = [], []
        for pg, rl, c in ((pg_i, None, cfg),
                          (pg_s, isl.relabel,
                           dataclasses.replace(cfg, partition="island"))):
            tp = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in params.items()}
            out = gcn_forward_full(tp, *_tensors(pg), c,
                                   relabel=rl).reshape(-1, C)
            if rl is not None:
                assert not out[V:].any()       # the pad rows read zero
            out = out[:V]
            out.sum().backward()
            outs.append(out.detach().numpy())
            grads.append({k: v.grad.numpy() for k, v in tp.items()})
        for got in outs:
            np.testing.assert_array_equal(got, want)
        for got in grads:
            for k in params:
                w = np.asarray(jgrad[k])
                if op == "add":
                    np.testing.assert_array_equal(got[k], w,
                                                  err_msg=(impl, k))
                else:
                    np.testing.assert_allclose(
                        got[k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                        err_msg=(impl, k))


def _sage_world(rng, V=64, F=5, B=4, K1=3, K2=3):
    g = _shuffled_clustered(V, 512, n_clusters=4, p_intra=0.9, seed=2)
    feats = rng.standard_normal((V, F)).astype(np.float32)
    batch = {
        "seeds": rng.integers(0, V, (1, B)).astype(np.int32),
        "nbrs1": rng.integers(0, V, (1, B, K1)).astype(np.int32),
        "mask1": rng.random((1, B, K1)) < 0.8,
        "nbrs2": rng.integers(0, V, (1, B * (1 + K1), K2)).astype(np.int32),
        "mask2": rng.random((1, B * (1 + K1), K2)) < 0.8,
        "labels": rng.integers(0, 4, (1, B)).astype(np.int32),
    }
    return g, feats, batch


@pytest.mark.parametrize("impl", IMPLS)
def test_sage_forward_island_parity(impl):
    """Sampled-path islandized ≡ interval bit for bit (the same rows
    fetched in the same order), and equal to the JAX package's
    islandized forward within 1e-5."""
    import jax.numpy as jnp

    from repro.core.gcn import GCNConfig as JGCNConfig
    from repro.core.gcn import sage_forward as j_sage
    from repro_torch.core.gcn import GCNConfig, gcn_schema, sage_forward

    rng = np.random.default_rng(1)
    g, feats, batch = _sage_world(rng)
    V, F = feats.shape
    isl = islandize(g, 1, pad_multiple=1)
    cfg = GCNConfig(n_features=F, hidden=8, n_classes=4, impl=impl)
    params = {k: rng.standard_normal(d.shape).astype(np.float32)
              for k, d in gcn_schema(cfg).items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    t_i = torch.from_numpy(feats).reshape(1, V, F)
    t_s = torch.from_numpy(isl.relabel_rows(feats)).reshape(1, V, F)
    with torch.no_grad():
        o_i = sage_forward(tp, t_i, batch, cfg)
        o_s = sage_forward(tp, t_s, batch,
                           dataclasses.replace(cfg, partition="island"),
                           relabel=isl.relabel)
        o_t = sage_forward(tp, t_s, batch,
                           dataclasses.replace(cfg, partition="island"),
                           relabel=torch.from_numpy(isl.relabel))
    assert torch.equal(o_i, o_s) and torch.equal(o_s, o_t)
    jcfg = JGCNConfig(n_features=F, hidden=8, n_classes=4,
                      impl=JIMPL[impl], partition="island")
    want = j_sage({k: jnp.asarray(v) for k, v in params.items()},
                  jnp.asarray(isl.relabel_rows(feats)).reshape(1, V, F),
                  {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                  relabel=isl.relabel)
    np.testing.assert_allclose(o_s.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_island_parity(impl):
    """One ``make_sage_train_step`` step on the islandized table ≡ the
    interval step bit for bit (parameters and metrics), and the JAX
    package's islandized step within the train tests' tolerance."""
    import jax
    import jax.numpy as jnp

    from repro.common.config import TrainConfig as JTrainConfig
    from repro.common.schema import init_params as j_init_params
    from repro.core.gcn import GCNConfig as JGCNConfig
    from repro.core.gcn import gcn_schema as j_schema
    from repro.optim import adamw_init as j_adamw_init
    from repro.train import make_sage_train_step as j_make_step
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.train import make_sage_train_step, state_from_jax

    rng = np.random.default_rng(4)
    g, feats, batch = _sage_world(rng, F=8)
    V, F = feats.shape
    isl = islandize(g, 1, pad_multiple=1)
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=1,
              weight_decay=0.0)
    jcfg = JGCNConfig(n_features=F, hidden=16, n_classes=4, fanout=3,
                      impl=JIMPL[impl], partition="island")
    jparams = j_init_params(j_schema(jcfg), jax.random.PRNGKey(0))
    jstate = {"params": jparams,
              "opt": j_adamw_init(jparams, JTrainConfig(**kw)),
              "step": jnp.zeros((), jnp.int32)}
    t_s = isl.relabel_rows(feats).reshape(1, V, F)
    jstate, _ = j_make_step(jcfg, JTrainConfig(**kw),
                            feats=jnp.asarray(t_s), relabel=isl.relabel)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = GCNConfig(n_features=F, hidden=16, n_classes=4, fanout=3,
                    impl=impl)
    after = []
    for table, c, rl in ((feats.reshape(1, V, F), cfg, None),
                         (t_s, dataclasses.replace(cfg, partition="island"),
                          isl.relabel)):
        state = state_from_jax(jax.tree.map(np.asarray, {
            "params": jparams,
            "opt": j_adamw_init(jparams, JTrainConfig(**kw)),
            "step": jnp.zeros((), jnp.int32)}), device="cpu")
        step = make_sage_train_step(c, TrainConfig(**kw),
                                    feats=torch.from_numpy(table),
                                    relabel=rl)
        state, metrics = step(state, batch)
        after.append((state["params"], metrics))
    (p_i, m_i), (p_s, m_s) = after
    for k in p_i:
        assert torch.equal(p_i[k], p_s[k]), k
        np.testing.assert_allclose(p_s[k].numpy(),
                                   np.asarray(jstate["params"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in m_i:
        assert torch.equal(m_i[k], m_s[k]), k


@pytest.mark.parametrize("impl,scheduled", [("kernel", True),
                                            ("kernel", False),
                                            ("ref", None)])
def test_serving_engine_island_parity_with_cache(impl, scheduled):
    """Interval and island engines over the same graph, hot cache on,
    answer the same queries bit for bit with the same cache behaviour; the
    island engine's cache stays keyed on original ids. The JAX package's
    island engine serves the same rows."""
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import ServingEngine

    rng = np.random.default_rng(2)
    V, F = 64, 5
    g = _shuffled_clustered(V, 512, n_clusters=4, p_intra=0.9, seed=8)
    feats = rng.standard_normal((V, F)).astype(np.float32)
    indptr, indices, _ = g.to_csr()
    kw = dict(fanout=4, max_batch=4, max_delay_s=1e9, cache_capacity=16)
    eng_i = ServingEngine(feats, indptr, indices, impl=impl,
                          scheduled=scheduled, device="cpu", **kw)
    eng_s = ServingEngine(feats, indptr, indices, impl=impl,
                          scheduled=scheduled, device="cpu",
                          partition="island", **kw)
    ref = JServingEngine(feats, indptr, indices, impl=JIMPL[impl],
                         scheduled=scheduled, partition="island", **kw)
    assert eng_s.islands is not None
    np.testing.assert_array_equal(eng_s.islands.relabel, ref.islands.relabel)
    seeds = [3, 9, 3, 17]
    for _wave in range(2):                     # wave 2 hits the cache
        rids = [(eng_i.submit([s]), eng_s.submit([s]), ref.submit([s]))
                for s in seeds]
        for e in (eng_i, eng_s, ref):
            e.flush()
        for ri, rs, rj in rids:
            a, b, c = eng_i.result(ri), eng_s.result(rs), ref.result(rj)
            np.testing.assert_array_equal(a.self_rows, b.self_rows)
            np.testing.assert_array_equal(a.agg_rows, b.agg_rows)
            np.testing.assert_array_equal(a.from_cache, b.from_cache)
            np.testing.assert_array_equal(b.self_rows, c.self_rows)
            np.testing.assert_allclose(b.agg_rows, c.agg_rows, rtol=1e-6,
                                       atol=1e-6)
    assert eng_i.cache.snapshot() == eng_s.cache.snapshot()
    assert eng_s.cache.snapshot()["hits"] > 0
    for s in set(seeds):
        assert s in eng_s.cache and s in eng_i.cache


def test_partition_knob_validation():
    """The JAX rule: the knob and the relabel map travel together, and an
    unknown layout is refused, on every entry point that takes them."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.gcn import GCNConfig, sage_forward
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_sage_train_step

    island = GCNConfig(n_features=2, hidden=4, n_classes=2,
                       partition="island")
    interval = GCNConfig(n_features=2, hidden=4, n_classes=2)
    bogus = GCNConfig(n_features=2, hidden=4, n_classes=2, partition="hash")
    batch = {"seeds": np.zeros((1, 2), np.int32),
             "nbrs1": np.zeros((1, 2, 2), np.int32),
             "mask1": np.ones((1, 2, 2), bool),
             "nbrs2": np.zeros((1, 6, 2), np.int32),
             "mask2": np.ones((1, 6, 2), bool)}
    feats = torch.zeros((1, 8, 2))
    with pytest.raises(ValueError, match="requires the IslandPartition"):
        sage_forward({}, feats, batch, island)
    with pytest.raises(ValueError, match="requires partition='island'"):
        sage_forward({}, feats, batch, interval,
                     relabel=np.arange(8, dtype=np.int32))
    with pytest.raises(ValueError, match="unknown cfg.partition"):
        sage_forward({}, feats, batch, bogus)
    with pytest.raises(ValueError, match="requires the IslandPartition"):
        make_sage_train_step(island, TrainConfig(), feats=feats)
    with pytest.raises(ValueError, match="unknown partition"):
        ServingEngine(np.zeros((8, 2), np.float32), np.zeros(9, np.int64),
                      np.zeros(0, np.int64), partition="hash", device="cpu")
