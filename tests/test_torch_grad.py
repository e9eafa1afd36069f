"""Port parity: gradients through the GAS engine and the sampled dataflow.

``impl="ref"`` differentiates through native autograd and must equal the
JAX package's ``impl="xla"``; ``impl="kernel"`` carries the JAX custom-VJP
rules as ``torch.autograd.Function``s over the FAST-GAS kernel wrappers
(their plain versions here) and must equal ``impl="pallas"`` (interpret
mode). Tolerance 1e-5 as in ``tests/test_cgtrans_grad.py``; integer-valued
data bit for bit. The backward must really dispatch the kernel wrappers,
and the forward+backward dispatch counts must equal the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.analysis.contracts import (SAGE_FETCH_DISPATCH,
                                      SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD)
from repro.core import cgtrans as jcg
from repro.core import gas as jgas
from repro_torch.core import cgtrans, gas
from repro_torch.kernels.gas_scatter import kernel as K

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
JIMPL = {"kernel": "pallas", "ref": "xla"}


def _close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _values(rng, shape, exact):
    """Integer-valued (exact sums, many max/min ties) or normal data."""
    if exact:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# gas_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,exact", [("kernel", True), ("kernel", False),
                                        ("ref", False)])
def test_gather_grad_matches_reference(impl, exact):
    rng = np.random.default_rng([3, int(exact)])
    table = _values(rng, (150, 6), exact)
    ids = rng.integers(0, 150, (4, 23)).astype(np.int32)   # repeats
    u = _values(rng, (4, 23, 6), exact)
    want = jax.grad(lambda t: jnp.sum(jgas.gas_gather(
        t, jnp.asarray(ids), impl=JIMPL[impl]) * u))(jnp.asarray(table))
    t = _t(table, True)
    (gas.gas_gather(t, _t(ids), impl=impl) * _t(u)).sum().backward()
    _close(t.grad, want, exact)


def test_kernel_gather_refuses_other_ranks():
    with pytest.raises(NotImplementedError, match="2-D"):
        gas.gas_gather(torch.zeros(4, 3, 2), torch.zeros(2, dtype=torch.int32),
                       impl="kernel")


# ---------------------------------------------------------------------------
# gas_scatter_weighted: add / max / min, scheduled and not
# ---------------------------------------------------------------------------

def _scatter_inputs(rng, E, R, exact):
    """dst with out-of-range entries (≥ R), a mask, weights and values."""
    dst = rng.integers(0, R + 3, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    w = (rng.integers(-2, 3, E) if exact else rng.standard_normal(E)
         ).astype(np.float32)
    return dst, _values(rng, (E, 4), exact), w, mask


def _torch_scatter_grads(dst, vals, w, mask, R, op, impl, scheduled):
    d, m = _t(dst), _t(mask)
    sched = (gas.schedule_edges(d, m, R) if scheduled else None)
    if sched is not None:
        p = sched.perm.long()
        d, m = d[p], m[p]
        vals, w = vals[p.numpy()], w[p.numpy()]
    v, wt = _t(vals, True), _t(w, True)
    out = gas.gas_scatter_weighted(d, v, wt, m, R, op=op, impl=impl,
                                   schedule=sched)
    u = np.random.default_rng(9).integers(-2, 3, out.shape)
    fin = torch.isfinite(out)
    (torch.where(fin, out, torch.zeros(())) * _t(u.astype(np.float32))
     ).sum().backward()
    # the oracle's compare ops leave the weights unused (no grad); JAX and
    # the kernel rule give zeros
    d_w = wt.grad if wt.grad is not None else torch.zeros_like(wt)
    return out.detach(), v.grad, d_w, sched


def _jax_scatter_grads(dst, vals, w, mask, R, op, impl, scheduled):
    d, m = jnp.asarray(dst), jnp.asarray(mask)
    sched = jgas.schedule_edges(d, m, R) if scheduled else None
    if sched is not None:
        p = np.asarray(sched.perm)
        d, m, vals, w = d[p], m[p], vals[p], w[p]
    u = np.random.default_rng(9).integers(-2, 3, (R, vals.shape[1])
                                           ).astype(np.float32)

    def loss(v, wt):
        out = jgas.gas_scatter_weighted(d, v, wt, m, R, op=op, impl=impl,
                                        schedule=sched)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * u)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(w))


@pytest.mark.parametrize("op,E,scheduled,exact", [
    ("add", 37, False, True),
    ("add", 128, True, True),
    ("add", 37, True, False),
    ("max", 37, True, True),
    ("max", 128, False, True),
    ("min", 128, True, True),
    ("min", 37, False, False),
])
def test_scatter_weighted_kernel_grad_matches_pallas(op, E, scheduled, exact):
    rng = np.random.default_rng([E, len(op), int(scheduled), int(exact)])
    R = 9
    args = _scatter_inputs(rng, E, R, exact)
    jv, jw = _jax_scatter_grads(*args, R, op, "pallas", scheduled)
    out, tv, tw, sched = _torch_scatter_grads(*args, R, op, "kernel",
                                              scheduled)
    _close(tv, jv, exact)
    _close(tw, jw, exact)
    # the same backward through native autograd of the oracle
    _, rv, rw, _ = _torch_scatter_grads(*args, R, op, "ref", scheduled)
    _close(tv, rv, exact)
    _close(tw, rw, exact)
    if op != "add":
        assert float(tw.abs().sum()) == 0.0


@pytest.mark.parametrize("op", ["add", "max"])
def test_scatter_weighted_ref_grad_matches_xla(op):
    rng = np.random.default_rng([len(op), 5])
    args = _scatter_inputs(rng, 37, 9, True)
    jv, jw = _jax_scatter_grads(*args, 9, op, "xla", False)
    _, tv, tw, _ = _torch_scatter_grads(*args, 9, op, "ref", False)
    _close(tv, jv, True)
    _close(tw, jw, True)


@pytest.mark.parametrize("seed", range(6))
def test_scatter_weighted_kernel_grad_equals_ref_on_ties(seed):
    """Values from {-1, 0, 1}: most rows hold a tie, so the tie-count
    scatter decides every share; kernel ≡ ref bit for bit, every op."""
    rng = np.random.default_rng(seed)
    E, R = int(rng.integers(1, 200)), int(rng.integers(1, 20))
    dst, _, w, mask = _scatter_inputs(rng, E, R, True)
    vals = rng.integers(-1, 2, (E, 4)).astype(np.float32)
    for op in ("add", "max", "min"):
        for scheduled in (False, True):
            got = _torch_scatter_grads(dst, vals, w, mask, R, op, "kernel",
                                       scheduled)
            want = _torch_scatter_grads(dst, vals, w, mask, R, op, "ref",
                                        scheduled)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the sampled dataflow: aggregate_sampled / aggregate_multi
# ---------------------------------------------------------------------------

P_, PART, F = 2, 16, 4


def _cotangent(rng, shape, exact):
    """Integer multiples of 12 when exact: divided by any count or tie
    count up to 4 (the mean, the even split) they stay integers, so every
    sum in the backward is exact."""
    return 12 * _values(rng, shape, True) if exact else _values(rng, shape,
                                                                False)


def _sampled_world(rng, B=7, K=3, exact=False):
    feats = _values(rng, (P_, PART, F), exact)
    nb = rng.integers(0, P_ * PART, (P_, B, K)).astype(np.int32)
    mk = rng.random((P_, B, K)) < 0.8
    return feats, nb, mk, _cotangent(rng, (P_, B, F), exact)


def _sampled_grad_torch(feats, blocks, us, op, impl, chunk):
    f = _t(feats, True)
    outs = cgtrans.aggregate_multi(
        f, [(_t(n), _t(m)) for n, m in blocks], op=op, impl=impl,
        request_chunk=chunk)
    sum((o * _t(u)).sum() for o, u in zip(outs, us)).backward()
    return f.grad


def _sampled_grad_jax(feats, blocks, us, op, impl, chunk):
    def loss(f):
        outs = jcg.aggregate_multi(
            f, [(jnp.asarray(n), jnp.asarray(m)) for n, m in blocks],
            mesh=None, op=op, impl=impl, request_chunk=chunk)
        return sum(jnp.sum(o * u) for o, u in zip(outs, us))
    return jax.grad(loss)(jnp.asarray(feats))


@pytest.mark.parametrize("impl,op,chunk", [
    ("kernel", "add", None),
    ("kernel", "max", 3),
    ("kernel", "min", None),
    ("ref", "add", 4),
    ("ref", "max", None),
])
def test_sampled_grad_matches_reference(impl, op, chunk):
    rng = np.random.default_rng([len(op), chunk or 0, len(impl)])
    feats, nb, mk, u = _sampled_world(rng)
    want = _sampled_grad_jax(feats, [(nb, mk)], [u], op, JIMPL[impl], chunk)
    got = _sampled_grad_torch(feats, [(nb, mk)], [u], op, impl, chunk)
    _close(got, want, False)


@pytest.mark.parametrize("impl,chunk", [("kernel", None), ("kernel", 2),
                                        ("ref", 3)])
def test_multi_grad_matches_reference_bit_exact(impl, chunk):
    """A K=1 self-row segment beside a fan-out segment (the coalesced
    sage_forward fetch), integer data: bit for bit."""
    rng = np.random.default_rng([chunk or 0, len(impl)])
    feats, nb2, mk2, u2 = _sampled_world(rng, B=6, K=4, exact=True)
    nb1 = rng.integers(0, P_ * PART, (P_, 5, 1)).astype(np.int32)
    mk1 = np.ones((P_, 5, 1), bool)
    u1 = _cotangent(rng, (P_, 5, F), True)
    blocks, us = [(nb1, mk1), (nb2, mk2)], [u1, u2]
    want = _sampled_grad_jax(feats, blocks, us, "add", JIMPL[impl], chunk)
    got = _sampled_grad_torch(feats, blocks, us, "add", impl, chunk)
    _close(got, want, True)


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_sampled_grad_chunked_equals_unchunked_bit_exact(op):
    rng = np.random.default_rng([len(op), 11])
    feats, nb, mk, u = _sampled_world(rng, B=13, K=4, exact=True)
    for impl in ("kernel", "ref"):
        full = _sampled_grad_torch(feats, [(nb, mk)], [u], op, impl, None)
        for chunk in (1, 3, 64):
            got = _sampled_grad_torch(feats, [(nb, mk)], [u], op, impl, chunk)
            np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_or_grads_are_zero():
    """op="or" is flat: its output carries no gradient on either backend,
    and the feature table's gradient is exactly zero, as in JAX."""
    rng = np.random.default_rng(4)
    feats = (rng.random((P_, PART, F)) < 0.5).astype(np.float32)
    nb = rng.integers(0, P_ * PART, (P_, 5, 3)).astype(np.int32)
    mk = rng.random((P_, 5, 3)) < 0.8
    for impl in ("kernel", "ref"):
        f = _t(feats, True)
        out = cgtrans.aggregate_sampled(f, _t(nb), _t(mk), op="or", impl=impl)
        assert not out.requires_grad, impl
        g, = torch.autograd.grad(out.sum() + (f * 0).sum(), f)
        want = jax.grad(lambda x: jnp.sum(jcg.aggregate_sampled(
            x, jnp.asarray(nb), jnp.asarray(mk), mesh=None, op="or",
            impl=JIMPL[impl])))(jnp.asarray(feats))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        assert float(g.abs().sum()) == 0.0


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_all_masked_seed_grad_finite_and_zero(op, impl):
    rng = np.random.default_rng([len(op), len(impl)])
    feats, nb, _, _ = _sampled_world(rng, B=5)
    f = _t(feats, True)
    out = cgtrans.aggregate_sampled(f, _t(nb), torch.zeros(nb.shape,
                                                           dtype=torch.bool),
                                    op=op, impl=impl)
    loss = (out ** 2).sum()                     # deliberately unmasked
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert bool(torch.isfinite(f.grad).all())
    np.testing.assert_array_equal(f.grad.numpy(), 0.0)


# ---------------------------------------------------------------------------
# the backward runs the kernels, and counts as the reference does
# ---------------------------------------------------------------------------

def _counting_plain(monkeypatch):
    """Count calls of both kernels' plain versions (the CPU stand-ins the
    wrappers call) by kernel name."""
    calls = {"banded": 0, "dense": 0}
    for name in calls:
        real = getattr(K, f"gas_scatter_{name}_plain")

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, f"gas_scatter_{name}_plain", counted)
    return calls


def test_kernel_backward_dispatches_the_kernel(monkeypatch):
    """The gather's backward is a scatter on the dense grid; a scheduled
    max's backward counts its ties on the banded walk. Both show in
    ``count_dispatches`` around ``.backward()`` alone."""
    calls = _counting_plain(monkeypatch)
    rng = np.random.default_rng(0)
    table = _t(rng.standard_normal((16, 4)).astype(np.float32), True)
    ids = _t(rng.integers(0, 16, 23).astype(np.int32))
    out = gas.gas_gather(table, ids, impl="kernel")
    assert calls == {"banded": 0, "dense": 0}, "the forward is a plain index"
    with gas.count_dispatches() as c:
        out.sum().backward()
    assert c["kernel_scatter"] == 1 and c["reduce"] == 1, dict(c)
    assert calls == {"banded": 0, "dense": 1}

    dst = _t(np.sort(rng.integers(0, 8, 23)).astype(np.int32))
    m = torch.ones(23, dtype=torch.bool)
    sched = gas.schedule_edges(dst, m, 8, assume_sorted=True)
    vals = _t(rng.integers(-2, 3, (23, 4)).astype(np.float32), True)
    out = gas.gas_scatter_weighted(dst, vals, torch.ones(23), m, 8, op="max",
                                   impl="kernel", schedule=sched)
    assert calls == {"banded": 1, "dense": 1}
    with gas.count_dispatches() as c:
        out.sum().backward()
    assert c["kernel_scatter"] == 1, dict(c)
    assert calls == {"banded": 2, "dense": 1}, "ties not on the banded walk"


def _count_pallas_calls(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for p in eqn.params.values():
            for s in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(s, "jaxpr", s)
                if hasattr(inner, "eqns"):
                    n += _count_pallas_calls(inner)
    return n


@pytest.mark.parametrize("form", ["separate", "coalesced"])
@pytest.mark.parametrize("op,chunk", [("add", None), ("max", None),
                                      ("add", 2), ("max", 2)])
def test_fwd_bwd_dispatch_counts_equal_reference(form, op, chunk):
    """Forward + backward of the sage fetch pair (a K=1 self-row segment,
    a fan-out segment), separate or coalesced. Unchunked, every counter
    equals the JAX package's trace-time count, and add meets
    ``SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD`` (3 separate, 2 coalesced).
    Chunked, kernel scatters equal the ``pallas_call`` sites of JAX's
    grad program, and finds its count: JAX's trace-time counter ticks a
    scan body's forward scatter twice under ``jax.grad`` (the primal
    trace, then the custom-VJP forward), while its program holds one
    call site."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((1, 32, F)).astype(np.float32)
    nb1 = rng.integers(0, 32, (1, 6, 1)).astype(np.int32)
    mk1 = np.ones((1, 6, 1), bool)
    nb2 = rng.integers(0, 32, (1, 6, 3)).astype(np.int32)
    mk2 = rng.random((1, 6, 3)) < 0.8
    blocks = [(nb1, mk1), (nb2, mk2)]

    def jloss(f):
        kw = dict(mesh=None, op=op, impl="pallas", request_chunk=chunk)
        bl = [(jnp.asarray(n), jnp.asarray(m)) for n, m in blocks]
        outs = (jcg.aggregate_multi(f, bl, **kw) if form == "coalesced"
                else [jcg.aggregate_sampled(f, n, m, **kw) for n, m in bl])
        return sum(jnp.sum(o) for o in outs)

    with jgas.count_dispatches() as jc:
        jaxpr = jax.make_jaxpr(jax.grad(jloss))(jnp.asarray(feats))
    f = _t(feats, True)
    with gas.count_dispatches() as tc:
        kw = dict(op=op, impl="kernel", request_chunk=chunk)
        bl = [(_t(n), _t(m)) for n, m in blocks]
        outs = (cgtrans.aggregate_multi(f, bl, **kw) if form == "coalesced"
                else [cgtrans.aggregate_sampled(f, n, m, **kw)
                      for n, m in bl])
        sum(o.sum() for o in outs).backward()
    assert tc["kernel_scatter"] == _count_pallas_calls(jaxpr.jaxpr), (
        dict(tc), dict(jc))
    assert tc["find"] == jc["find"]
    assert tc["reduce"] == tc["kernel_scatter"]
    if chunk is None:
        assert dict(tc) == dict(jc)
        assert tc["find"] == SAGE_FETCH_DISPATCH[form]["find"]
        if op == "add":
            assert tc["kernel_scatter"] == \
                SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD[form]


def test_backward_of_a_suspended_forward_does_not_tick():
    """A chunk loop's later passes run with counting suspended; their
    backward rules stay silent too, wherever ``.backward()`` runs."""
    rng = np.random.default_rng(2)
    table = _t(rng.standard_normal((16, 4)).astype(np.float32), True)
    ids = _t(rng.integers(0, 16, 9).astype(np.int32))
    from repro_torch.kernels.gas_scatter import ops as gas_ops
    with gas_ops.suspend_counting():
        out = gas.gas_gather(table, ids, impl="kernel")
    with gas.count_dispatches() as c:
        out.sum().backward()
    assert dict(c) == {}
    np.testing.assert_array_equal(
        table.grad.numpy(),
        np.bincount(ids.numpy(), minlength=16)[:, None].repeat(4, 1))


# ---------------------------------------------------------------------------
# the fused gather-and-scatter against the composition it replaces
# ---------------------------------------------------------------------------

def _composition(table, stream):
    """One add aggregation as the gather and the scatter, called directly:
    what ``gas.gas_gather_scatter`` replaces on the kernel route."""
    return gas.gas_scatter_weighted(
        stream.dst, gas.gas_gather(table, stream.src, impl="kernel"),
        stream.weights, stream.mask, stream.n_rows, op="add", impl="kernel",
        schedule=stream.schedule)


def _edge_world(rng, P, part, E, F):
    """Normal features, (P, E) edges as ``partition_by_src`` lays them
    out (local sources, global destinations with dead ones, a mask)."""
    V = P * part
    feats = rng.standard_normal((P, part, F)).astype(np.float32)
    src = rng.integers(0, part, (P, E)).astype(np.int32)
    dst = rng.integers(-2, V + 2, (P, E)).astype(np.int32)
    w = (rng.random((P, E)) + 0.05).astype(np.float32)
    mask = rng.random((P, E)) < 0.85
    return feats, src, dst, w, mask


def _bits(x):
    return np.ascontiguousarray(x.detach().numpy()).view(np.int32)


@pytest.mark.parametrize("F", [32, 40])
@pytest.mark.parametrize("w_grad", [False, True])
def test_fused_aggregation_equals_the_composition(F, w_grad):
    """``aggregate_stream(impl="kernel")`` (the banded walk reading the
    table) against the gather and the scatter called directly, on normal
    data: the result, d/dfeats and, where the weights require one, d/dw,
    bit for bit, and the same fwd+bwd dispatch counts."""
    rng = np.random.default_rng([F, w_grad])
    feats, src, dst, w, mask = _edge_world(rng, 2, 48, 300, F)
    u = _t(rng.standard_normal((96, F)).astype(np.float32))
    got = {}
    for fused in (True, False):
        f, wt = _t(feats, True), _t(w, w_grad)
        with gas.count_dispatches() as c:
            st = cgtrans.edge_stream(_t(src), _t(dst), wt, _t(mask),
                                     f.shape[:2], impl="kernel")
            out = (cgtrans.aggregate_stream(f, st, impl="kernel")
                   .reshape(96, F) if fused
                   else _composition(f.reshape(96, F), st))
            (out * u).sum().backward()
        got[fused] = (out, f.grad, wt.grad, dict(c))
    (o1, f1, w1, c1), (o0, f0, w0, c0) = got[True], got[False]
    np.testing.assert_array_equal(_bits(o1), _bits(o0))
    np.testing.assert_array_equal(_bits(f1), _bits(f0))
    assert (w1 is None) == (w0 is None) == (not w_grad)
    if w_grad:
        np.testing.assert_array_equal(_bits(w1), _bits(w0))
        assert float(w1.abs().sum()) > 0
    assert c1 == c0 == {"find": 1, "reduce": 2, "kernel_scatter": 2}


def _composed_gcn(params, feats, *args):
    """``gcn_forward_full``'s add layers with each aggregation the
    composition, called directly."""
    *edges, cfg = args
    stream = cgtrans.edge_stream(*edges, feats.shape[:2], impl="kernel")
    h = feats
    for i in range(cfg.n_layers):
        Pn, part, F = h.shape
        agg = _composition(h.reshape(Pn * part, F), stream).reshape(h.shape)
        h = torch.relu(torch.einsum("pvf,fh->pvh", torch.cat([h, agg], -1),
                                    params[f"w{i}"]) + params[f"b{i}"])
    return torch.einsum("pvh,hc->pvc", h, params["w_out"]) + params["b_out"]


def test_a_training_step_equals_the_composition():
    """A full-graph GCN training step's loss and every parameter's
    gradient (and the input table's) through ``gcn_forward_full`` on the
    fused route equal the same step over the composition, bit for bit."""
    from repro_torch.core.gcn import GCNConfig, gcn_forward_full
    rng = np.random.default_rng(7)
    F, H, C = 40, 24, 5
    feats, src, dst, w, mask = _edge_world(rng, 2, 48, 400, F)
    cfg = GCNConfig(n_features=F, hidden=H, n_classes=C, impl="kernel")
    shapes = {"w0": (2 * F, H), "b0": (H,), "w1": (2 * H, H), "b1": (H,),
              "w_out": (H, C), "b_out": (C,)}
    p0 = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in shapes.items()}
    labels = torch.from_numpy(rng.integers(0, C, 96))
    edges = tuple(_t(a) for a in (src, dst, w, mask))
    got = []
    for forward in (gcn_forward_full, _composed_gcn):
        params = {k: _t(v, True) for k, v in p0.items()}
        x = _t(feats, True)
        logits = forward(params, x, *edges, cfg).reshape(96, C)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        keys = sorted(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys] + [x])
        got.append([loss, *grads])
    for a, b in zip(*got):
        np.testing.assert_array_equal(_bits(a), _bits(b))
