"""Port parity: full-graph GCN, unsharded — ``aggregate_edges``,
``build_edge_schedule`` and ``gcn_forward_full``.

``impl="ref"`` must equal the JAX package's ``impl="xla"`` and
``impl="kernel"`` its ``impl="pallas"`` (interpret mode): bit for bit on
integer-valued data for every op, unscheduled, scheduled and with a
precomputed schedule; the gradients in the feature table and the edge
weights; ``gcn_forward_full`` at 2 and 3 layers and its parameter
gradients within 1e-5; the schedule built and its permutation applied once
per forward; and the dispatch counts, forward and forward + backward,
equal to the JAX counter. JAX is imported only where the reference is
computed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cgtrans, gas
from repro_torch.core.gcn import GCNConfig, gcn_forward_full, params_from_jax
from repro_torch.graph import partition_by_src, uniform_graph

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

JIMPL = {"ref": "xla", "kernel": "pallas"}
OPS = ("add", "max", "min", "or")
P, V, E, F = 2, 96, 700, 12
TOL = dict(rtol=1e-5, atol=1e-5)


def _world(seed=0, exact=True):
    """(feats, src, dst, weights, mask) numpy, laid out by
    ``partition_by_src`` over P partitions; integer-valued feats and
    weights in [-2, 2] when ``exact`` (sums and max/min ties exact)."""
    g = uniform_graph(V, E, seed=seed, n_features=F, weights=True)
    pg = partition_by_src(g, P)
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-8, 9, pg.features.shape).astype(np.float32)
             if exact else pg.features.astype(np.float32))
    w = (rng.integers(-2, 3, pg.weights.shape).astype(np.float32)
         if exact else pg.weights)
    return feats, pg.src, pg.dst, w, pg.mask


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _j(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def _sched_kw(mode, dst, mask, lib):
    if mode == "none":
        return dict(scheduled=False)
    if mode == "auto":
        return dict(scheduled=True)
    return dict(schedule=lib.build_edge_schedule(dst, mask, P * (V // P)))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("mode", ["none", "auto", "pre"])
def test_aggregate_edges_matches_reference(op, impl, mode):
    from repro.core import cgtrans as jcg
    from repro.core import gas as jgas

    feats, src, dst, w, mask = _world(1)
    with jgas.count_dispatches() as jc:
        want = jcg.aggregate_edges(
            _j(feats), _j(src), _j(dst), _j(w), _j(mask), op=op,
            impl=JIMPL[impl], **_sched_kw(mode, _j(dst), _j(mask), jcg))
    with gas.count_dispatches() as tc:
        got = cgtrans.aggregate_edges(
            _t(feats), _t(src), _t(dst), _t(w), _t(mask), op=op, impl=impl,
            **_sched_kw(mode, _t(dst), _t(mask), cgtrans))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dict(tc) == dict(jc)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_aggregate_edges_on_normal_data(op, impl):
    from repro.core import cgtrans as jcg

    feats, src, dst, w, mask = _world(2, exact=False)
    want = jcg.aggregate_edges(_j(feats), _j(src), _j(dst), _j(w), _j(mask),
                               op=op, impl=JIMPL[impl])
    got = cgtrans.aggregate_edges(_t(feats), _t(src), _t(dst), _t(w),
                                  _t(mask), op=op, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schedule_matches_reference():
    from repro.core import cgtrans as jcg

    _, _, dst, _, mask = _world(3)
    a = jcg.build_edge_schedule(_j(dst), _j(mask), V)
    b = cgtrans.build_edge_schedule(_t(dst), _t(mask), V)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def _cot(seed, shape):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float32)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("impl,mode", [("ref", "none"), ("kernel", "none"),
                                       ("kernel", "auto"), ("kernel", "pre")])
def test_aggregate_edges_gradients_match_reference(op, impl, mode):
    """d/dfeats and d/dweights of sum(finite(out) · u) on integer data: bit
    for bit for add and or; within 1e-5 for max / min, whose tied edges
    share a cotangent cell as g / ties (a third is not dyadic, so the
    table's scatter-add of the shares rounds by its order). The forward +
    backward dispatch counts equal the JAX counter's."""
    import jax
    import jax.numpy as jnp

    from repro.core import cgtrans as jcg
    from repro.core import gas as jgas

    feats, src, dst, w, mask = _world(4)
    u = _cot(5, feats.shape)

    def jloss(f, wt):
        out = jcg.aggregate_edges(
            f, _j(src), _j(dst), wt, _j(mask), op=op, impl=JIMPL[impl],
            **_sched_kw(mode, _j(dst), _j(mask), jcg))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * _j(u))

    with jgas.count_dispatches() as jc:
        jf, jw = jax.grad(jloss, argnums=(0, 1))(_j(feats), _j(w))
    f, wt = _t(feats, True), _t(w, True)
    with gas.count_dispatches() as tc:
        out = cgtrans.aggregate_edges(
            f, _t(src), _t(dst), wt, _t(mask), op=op, impl=impl,
            **_sched_kw(mode, _t(dst), _t(mask), cgtrans))
        loss = (torch.where(torch.isfinite(out), out, torch.zeros(()))
                * _t(u)).sum()
        if loss.requires_grad:          # or: flat, its gradients stopped
            loss.backward()
    for got, want in ((f.grad, jf), (wt.grad, jw)):
        got = np.zeros_like(np.asarray(want)) if got is None else got.numpy()
        if op in ("max", "min"):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        else:
            np.testing.assert_array_equal(got, np.asarray(want))
    assert dict(tc) == dict(jc)


# ---------------------------------------------------------------------------
# gcn_forward_full
# ---------------------------------------------------------------------------

def _cfg(lib_cfg, op, impl, **kw):
    return lib_cfg(n_features=F, hidden=16, n_classes=5, aggregate=op,
                   impl=impl, **kw)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_gcn_forward_full_matches_reference(op, impl, n_layers, monkeypatch):
    """Logits and the parameters' gradients within 1e-5 (normal data);
    one schedule built and one permutation applied for every layer and the
    backward on the kernel route, none on ``ref``."""
    import jax

    from repro.common.schema import init_params
    from repro.core import gcn as jgcn

    feats, src, dst, w, mask = _world(6, exact=False)
    jcfg = _cfg(jgcn.GCNConfig, op, JIMPL[impl], n_layers=n_layers)
    jparams = init_params(jgcn.gcn_schema(jcfg), jax.random.PRNGKey(0))
    u = np.random.default_rng(7).standard_normal((P, V // P, 5)).astype(
        np.float32)

    def jloss(p):
        return (jgcn.gcn_forward_full(p, _j(feats), _j(src), _j(dst), _j(w),
                                      _j(mask), jcfg) * _j(u)).sum()

    want = jgcn.gcn_forward_full(jparams, _j(feats), _j(src), _j(dst), _j(w),
                                 _j(mask), jcfg)
    jgrads = jax.grad(jloss)(jparams)

    params = {k: v.requires_grad_(True) for k, v in params_from_jax(
        jparams, device="cpu").items()}
    calls = {"schedule": 0, "permute": 0}

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(gas, "schedule_edges",
                        counted("schedule", gas.schedule_edges))
    monkeypatch.setattr(cgtrans, "_permuted",
                        counted("permute", cgtrans._permuted))
    logits = gcn_forward_full(params, _t(feats), _t(src), _t(dst), _t(w),
                              _t(mask), _cfg(GCNConfig, op, impl,
                                             n_layers=n_layers))
    (logits * _t(u)).sum().backward()
    once = 1 if impl == "kernel" else 0
    assert calls == {"schedule": once, "permute": once}
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               **TOL)
    for k, g in jgrads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **TOL)


def test_gcn_forward_full_dispatch_counts_equal_reference():
    """Forward and forward + backward in the parameters, kernel route:
    every counter equals the JAX package's."""
    import jax

    from repro.common.schema import init_params
    from repro.core import gas as jgas
    from repro.core import gcn as jgcn

    feats, src, dst, w, mask = _world(8, exact=False)
    for op in ("add", "max"):
        jcfg = _cfg(jgcn.GCNConfig, op, "pallas")
        jparams = init_params(jgcn.gcn_schema(jcfg), jax.random.PRNGKey(1))
        args = tuple(_j(x) for x in (feats, src, dst, w, mask))
        with jgas.count_dispatches() as jf:
            jgcn.gcn_forward_full(jparams, *args, jcfg)
        with jgas.count_dispatches() as jb:
            jax.grad(lambda p: jgcn.gcn_forward_full(p, *args, jcfg).sum())(
                jparams)
        params = {k: v.requires_grad_(True) for k, v in params_from_jax(
            jparams, device="cpu").items()}
        targs = tuple(_t(x) for x in (feats, src, dst, w, mask))
        cfg = _cfg(GCNConfig, op, "kernel")
        with gas.count_dispatches() as tf:
            gcn_forward_full(params, *targs, cfg)
        with gas.count_dispatches() as tb:
            gcn_forward_full(params, *targs, cfg).sum().backward()
        assert dict(tf) == dict(jf), (op, dict(tf), dict(jf))
        assert dict(tb) == dict(jb), (op, dict(tb), dict(jb))


def test_gcn_forward_full_knobs():
    """The wire is a no-op without a mesh and sparse layer-0 features are
    bit for bit dense; ``partition="island"`` without the relabel map and
    ``relabel=`` without it raise the JAX package's ``ValueError``; bad
    knobs raise as in the JAX package."""
    from repro_torch.common.schema import init_params
    from repro_torch.core.gcn import gcn_schema
    from repro_torch.core.sparse import sparse_fits, table_capacity

    feats, src, dst, w, mask = _world(9)
    feats = np.where(feats > 4, feats, 0)        # ReLU-like, ~1/4 dense
    targs = tuple(_t(x) for x in (feats, src, dst, w, mask))
    cfg = _cfg(GCNConfig, "add", "kernel")
    params = init_params(gcn_schema(cfg), 0, device="cpu")
    base = gcn_forward_full(params, *targs, cfg)
    cap = table_capacity(feats)
    assert sparse_fits(cap, F)              # the packed path really runs
    for kw in (dict(wire="bf16"), dict(wire="int8"),
               dict(features="sparse", sparse_capacity=cap)):
        got = gcn_forward_full(params, *targs, _cfg(GCNConfig, "add",
                                                    "kernel", **kw))
        assert torch.equal(got, base), kw
    for kw, err, match in (
            (dict(partition="island"), ValueError,
             "requires the IslandPartition"),
            (dict(wire="fp4"), ValueError, "unknown wire"),
            (dict(features="sparse"), ValueError, "sparse_capacity"),
            (dict(sparse_capacity=8), ValueError, "only applies"),
            (dict(dataflow="baseline", wire="bf16"), ValueError, "baseline")):
        with pytest.raises(err, match=match):
            gcn_forward_full(params, *targs,
                             _cfg(GCNConfig, "add", "kernel", **kw))
    with pytest.raises(ValueError, match="requires partition='island'"):
        gcn_forward_full(params, *targs, cfg, relabel=np.arange(V))
