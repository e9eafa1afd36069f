"""Port parity: the sampled CGTrans path (``core/cgtrans.py``), unsharded.

``aggregate_multi`` and ``aggregate_sampled`` on the port's kernel backend
must equal the JAX package's ``impl="pallas"`` bit for bit on integer-valued
data — segments K=1 (pure find) and K>1 (kernel scatter), chunked and
unchunked, scheduled and not, add/max/min/or — with equal dispatch
counters. A chunk loop counts its body once, as the reference's scan does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cgtrans as jcg
from repro.core import gas as jgas
from repro_torch.core import cgtrans, gas
from repro_torch.core.sparse import sparse_fits, table_capacity

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

V, F = 200, 10
JIMPL = {"kernel": "pallas", "ref": "xla"}


def _table(rng):
    return rng.integers(-8, 9, (1, V, F)).astype(np.float32)


def _segment(rng, R, K, p_mask=0.3):
    nbrs = rng.integers(0, V, (1, R, K)).astype(np.int32)
    mask = rng.random((1, R, K)) >= p_mask
    mask[0, 0] = False                 # one seed with no valid sample
    return nbrs, mask


def _both(feats, blocks, **kw):
    impl = kw.pop("impl")
    with jgas.count_dispatches() as jc:
        a = jcg.aggregate_multi(
            jnp.asarray(feats),
            [(jnp.asarray(n), jnp.asarray(m)) for n, m in blocks],
            impl=JIMPL[impl], **kw)
    with gas.count_dispatches() as tc:
        b = cgtrans.aggregate_multi(
            torch.from_numpy(feats),
            [(torch.from_numpy(n), torch.from_numpy(m)) for n, m in blocks],
            impl=impl, **kw)
    assert dict(jc) == dict(tc), (dict(jc), dict(tc))
    assert len(a) == len(b)
    return [np.asarray(x) for x in a], [y.numpy() for y in b]


@pytest.mark.parametrize("impl,op,chunk,scheduled", [
    ("kernel", "add", None, True),
    ("kernel", "add", 7, True),
    ("kernel", "max", None, True),
    ("kernel", "min", 5, True),
    ("kernel", "add", None, False),
    ("kernel", "max", 4, False),
    ("kernel", "or", None, True),
    ("ref", "add", None, None),
    ("ref", "min", 6, None),
])
def test_aggregate_multi_equals_reference(impl, op, chunk, scheduled):
    rng = np.random.default_rng([len(op), chunk or 0, int(bool(scheduled))])
    feats = _table(rng)
    if op == "or":
        feats = np.abs(feats) % 2
    blocks = [_segment(rng, 13, 1), _segment(rng, 9, 6),
              _segment(rng, 20, 4)]
    a, b = _both(feats, blocks, impl=impl, op=op, request_chunk=chunk,
                 scheduled=scheduled)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("K,chunk", [(1, None), (1, 3), (5, None), (5, 8)])
def test_aggregate_sampled_equals_reference(K, chunk):
    rng = np.random.default_rng(K * 10 + (chunk or 0))
    feats = _table(rng)
    nbrs, mask = _segment(rng, 17, K)
    a = jcg.aggregate_sampled(jnp.asarray(feats), jnp.asarray(nbrs),
                              jnp.asarray(mask), impl="pallas",
                              request_chunk=chunk)
    b = cgtrans.aggregate_sampled(torch.from_numpy(feats),
                                  torch.from_numpy(nbrs),
                                  torch.from_numpy(mask), impl="kernel",
                                  request_chunk=chunk)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_chunked_equals_unchunked_and_counts_body_once():
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(_table(rng))
    nbrs, mask = (torch.from_numpy(x) for x in _segment(rng, 31, 5))
    with gas.count_dispatches() as c_full:
        full = cgtrans.aggregate_sampled(feats, nbrs, mask, impl="kernel")
    with gas.count_dispatches() as c_chunk:
        chunked = cgtrans.aggregate_sampled(feats, nbrs, mask, impl="kernel",
                                            request_chunk=4)
    assert torch.equal(full, chunked)
    assert dict(c_full) == dict(c_chunk) == {"find": 1, "reduce": 1,
                                             "kernel_scatter": 1}


def test_segment_descriptor_equals_reference():
    shapes, tenants = [(3, 1), (3, 50), (2, 1), (2, 50)], [7, 7, 9, 9]
    a = jcg.segment_descriptor(shapes, tenants)
    b = cgtrans.segment_descriptor(shapes, tenants)
    assert tuple(a) == tuple(b)
    assert b.segments_of(9) == a.segments_of(9) == (2, 3)
    assert (b.n_ids, b.n_rows) == (a.n_ids, a.n_rows)
    for bad in ([], [(0, 1)]):
        with pytest.raises(ValueError):
            cgtrans.segment_descriptor(bad)


def test_knobs_outside_the_slice_raise():
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(_table(rng))
    blocks = [tuple(torch.from_numpy(x) for x in _segment(rng, 4, 3))]
    call = lambda **kw: cgtrans.aggregate_multi(feats, blocks, **kw)  # noqa
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(mesh=object())
    # without a mesh the wire and sparse features are validated no-ops
    base = call()
    for kw in (dict(wire="bf16"), dict(wire="int8")):
        for x, y in zip(call(**kw), base):
            assert torch.equal(x, y), kw
    sp = torch.where(feats > 3, feats, torch.zeros(()))    # ~30 % dense
    cap = table_capacity(sp)
    assert sparse_fits(cap, F)
    base = cgtrans.aggregate_multi(sp, blocks)
    for kw in (dict(), dict(dataflow="baseline", wire="bf16")):
        for x, y in zip(cgtrans.aggregate_multi(
                sp, blocks, features="sparse", sparse_capacity=cap, **kw),
                base):
            assert torch.equal(x, y), kw
    with pytest.raises(ValueError):
        call(wire="fp4")
    with pytest.raises(ValueError):
        call(wire="int8", dataflow="baseline")
    with pytest.raises(ValueError):
        call(dataflow="gcnax")
    with pytest.raises(ValueError):
        call(sparse_capacity=4)
    assert call(wire="f32", dataflow="baseline")[0].shape == (1, 4, F)
