"""Port parity: compressed-sparse features (``core/sparse.py``) and the
``features="sparse"`` knob, unsharded.

The codec against the JAX package's on the same rows (no subnormals: XLA
on the CPU flushes them inside the reference's ``encode_rows``); the
port's own subnormal rule (a subnormal is a nonzero: counted by
``table_capacity``, packed, and returned bit for bit); the ``sparse_fits``
gate and its dense fallback; and sparse ≡ dense for values and gradients
on both routes. JAX is imported only where the reference is computed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cgtrans, gas, sparse

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def _rows(seed, shape, density):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.random(shape) < density, x, 0.0).astype(np.float32)


@pytest.mark.parametrize("F,density", [(16, 0.3), (40, 0.5), (128, 0.1),
                                       (602, 0.2)])
def test_codec_equals_reference(F, density):
    import jax.numpy as jnp

    from repro.core import sparse as jsparse

    x = _rows(F, (3, 5, F), density)
    x[0, 0] = 0.0                                  # an empty row
    x[0, 1, -1] = -2.5                             # a bit in the last word
    cap = sparse.table_capacity(x)
    assert cap == jsparse.table_capacity(x)
    assert sparse.bitmap_words(F) == jsparse.bitmap_words(F)
    assert sparse.sparse_fits(cap, F) == jsparse.sparse_fits(cap, F)
    for density_ in (0.05, 0.3, 1.0):
        assert sparse.worst_case_capacity(F, density_) == \
            jsparse.worst_case_capacity(F, density_)
    jp, jb = jsparse.encode_rows(jnp.asarray(x), cap)
    packed, bitmap = sparse.encode_rows(torch.from_numpy(x), cap)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    assert bitmap.dtype == torch.int32
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(sparse.popcount(bitmap).numpy(),
                                  np.asarray(jsparse.popcount(jb)))
    np.testing.assert_array_equal(
        sparse.decode_rows(packed, bitmap, F).numpy(), x)
    # a too-small capacity drops trailing nonzeros as the reference does
    small = max(cap - 8, 1)
    jd = jsparse.decode_rows(*jsparse.encode_rows(jnp.asarray(x), small), F)
    np.testing.assert_array_equal(
        sparse.decode_rows(*sparse.encode_rows(torch.from_numpy(x), small),
                           F).numpy(), np.asarray(jd))
    assert sparse.density_stats(x) == jsparse.density_stats(x)


def test_subnormals_are_nonzeros_and_round_trip_bit_for_bit():
    """The port's rule: ``x != 0`` holds for a subnormal, so it is counted,
    packed and decoded unchanged (the JAX package's caveat: XLA on the CPU
    flushes them in its encode, and its capacity and encode disagree)."""
    tiny = np.array([5.11e-40, 3.82e-44, -1e-45, np.finfo(np.float32).tiny],
                    np.float32)
    assert (tiny != 0).all() and (np.abs(tiny[:3]) <
                                  np.finfo(np.float32).tiny).all()
    x = np.zeros((4, 24), np.float32)
    x[0, :4] = tiny
    x[1, 7] = tiny[1]
    x[2, ::3] = 1.0
    x[3, 20:] = tiny
    cap = sparse.table_capacity(x)
    assert cap == 8                       # row 2's 8 nonzeros, aligned to 8
    t = torch.from_numpy(x)
    packed, bitmap = sparse.encode_rows(t, cap)
    np.testing.assert_array_equal(sparse.popcount(bitmap).numpy(),
                                  (x != 0).sum(-1))
    back = sparse.decode_rows(packed, bitmap, 24).numpy()
    assert back.tobytes() == x.tobytes()
    # and the sparse gather returns them bit for bit
    ids = torch.tensor([3, 0, 1, 1])
    rows = cgtrans._find(t, ids, impl="ref", sparse_cap=cap)
    assert rows.numpy().tobytes() == x[[3, 0, 1, 1]].tobytes()


def test_sparse_fits_gate_and_dense_fallback():
    F = 64                                # 2 bitmap words
    assert sparse.sparse_fits(56, F) and not sparse.sparse_fits(62, F)
    assert cgtrans._resolve_sparse("sparse", 56, F) == 56
    assert cgtrans._resolve_sparse("sparse", 62, F) is None   # dense
    assert cgtrans._resolve_sparse("dense", None, F) is None
    for bad in (dict(features="dense", cap=8), dict(features="sparse",
                                                    cap=None),
                dict(features="sparse", cap=0)):
        with pytest.raises(ValueError):
            cgtrans._resolve_sparse(bad["features"], bad["cap"], F)
    with pytest.raises(ValueError, match="unknown features"):
        sparse.validate_features("csr")
    # a dense table measures capacity F: the gate sends it the dense way,
    # and the gather ticks one find either way
    x = np.ones((5, F), np.float32)
    cap = sparse.table_capacity(x)
    assert cap == F and cgtrans._resolve_sparse("sparse", cap, F) is None
    feats = torch.from_numpy(x[None])
    nb = torch.randint(0, 5, (1, 3, 2), dtype=torch.int32)
    mk = torch.ones((1, 3, 2), dtype=torch.bool)
    with gas.count_dispatches() as c:
        out = cgtrans.aggregate_sampled(feats, nb, mk, features="sparse",
                                        sparse_capacity=cap)
    assert c["find"] == 1
    np.testing.assert_array_equal(out.numpy(),
                                  cgtrans.aggregate_sampled(feats, nb,
                                                            mk).numpy())


def _edge_world(seed, V=48, E=300, F=40):
    rng = np.random.default_rng(seed)
    feats = np.maximum(rng.integers(-6, 5, (1, V, F)), 0).astype(np.float32)
    src = rng.integers(0, V, (1, E)).astype(np.int32)
    dst = rng.integers(0, V, (1, E)).astype(np.int32)
    w = rng.integers(-2, 3, (1, E)).astype(np.float32)
    mask = rng.random((1, E)) < 0.9
    return feats, src, dst, w, mask


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("op", ["add", "max"])
def test_sparse_equals_dense_for_values_and_gradients(impl, op):
    """Integer-valued, ReLU-like data: the edge aggregation and the sampled
    fetch on ``features="sparse"`` equal the dense path bit for bit, values
    and the table's and weights' gradients."""
    feats, src, dst, w, mask = _edge_world(3)
    cap = sparse.table_capacity(feats)
    assert sparse.sparse_fits(cap, feats.shape[-1])
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.integers(-3, 4, feats.shape).astype(np.float32))
    nb = torch.from_numpy(rng.integers(0, feats.shape[1], (1, 6, 4)
                                       ).astype(np.int32))
    mk = torch.from_numpy(rng.random((1, 6, 4)) < 0.75)
    us = torch.from_numpy(rng.integers(-3, 4, (1, 6, feats.shape[-1])
                                       ).astype(np.float32))

    def run(features):
        f = torch.from_numpy(feats).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        kw = dict(impl=impl, op=op, features=features,
                  sparse_capacity=cap if features == "sparse" else None)
        agg = cgtrans.aggregate_edges(f, torch.from_numpy(src),
                                      torch.from_numpy(dst), wt,
                                      torch.from_numpy(mask), **kw)
        fin = torch.where(torch.isfinite(agg), agg, torch.zeros(()))
        smp = cgtrans.aggregate_sampled(f, nb, mk, **kw)
        ((fin * u).sum() + (smp * us).sum()).backward()
        # (max ignores the weights: no gradient reaches them on ref)
        return (agg.detach(), smp.detach(), f.grad,
                torch.zeros_like(wt) if wt.grad is None else wt.grad)

    for a, b in zip(run("sparse"), run("dense")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
