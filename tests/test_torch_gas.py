"""Port parity: the GAS engine primitives (``core/gas.py``), forward.

``gas_scatter_weighted`` on the port's kernel backend (CPU tensors: the
kernels' plain versions) must equal the JAX package's ``impl="pallas"``
bit for bit on integer-valued data, including the ``or`` round trip
through an int cast and ``max``; the oracle backends (``ref`` vs ``xla``)
likewise. The dispatch counters must agree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gas as jgas
from repro_torch.core import gas

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(seed, E=500, n_rows=150, F=12, op="add"):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-2, n_rows + 2, E).astype(np.int32)
    mask = rng.random(E) < 0.75
    if op == "or":
        vals = rng.integers(-2, 3, (E, F)).astype(np.float32)
    else:
        vals = rng.integers(-7, 8, (E, F)).astype(np.float32)
    w = rng.integers(-3, 4, E).astype(np.float32)
    return dst, vals, w, mask, n_rows


@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_scatter_weighted_kernel_equals_pallas(op, scheduled):
    dst, vals, w, mask, n_rows = _case(1, op=op)
    js = ts = None
    if scheduled:
        js = jgas.schedule_edges(jnp.asarray(dst), jnp.asarray(mask), n_rows)
        ts = gas.schedule_edges(_t(dst), _t(mask), n_rows)
        perm = np.asarray(js.perm)
        np.testing.assert_array_equal(perm, ts.perm.numpy())
        dst, vals, w, mask = dst[perm], vals[perm], w[perm], mask[perm]
    with jgas.count_dispatches() as jc:
        a = jgas.gas_scatter_weighted(jnp.asarray(dst), jnp.asarray(vals),
                                      jnp.asarray(w), jnp.asarray(mask),
                                      n_rows, op=op, impl="pallas",
                                      schedule=js)
    with gas.count_dispatches() as tc:
        b = gas.gas_scatter_weighted(_t(dst), _t(vals), _t(w), _t(mask),
                                     n_rows, op=op, impl="kernel",
                                     schedule=ts)
    assert dict(jc) == dict(tc) == {"reduce": 1, "kernel_scatter": 1}
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
def test_scatter_weighted_ref_equals_xla(op):
    dst, vals, w, mask, n_rows = _case(2, op=op)
    a = jgas.gas_scatter_weighted(jnp.asarray(dst), jnp.asarray(vals),
                                  jnp.asarray(w), jnp.asarray(mask), n_rows,
                                  op=op, impl="xla")
    b = gas.gas_scatter_weighted(_t(dst), _t(vals), _t(w), _t(mask), n_rows,
                                 op=op, impl="ref")
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("op", ["add", "max", "min", "or"])
def test_raw_gas_scatter_equals_reference(impl, op):
    dst, vals, _, _, n_rows = _case(3, op=op)
    if op == "or":
        vals = np.abs(vals).astype(np.int32)
    jimpl = {"ref": "xla", "kernel": "pallas"}[impl]
    a = jgas.gas_scatter(jnp.asarray(dst), jnp.asarray(vals), n_rows, op=op,
                         impl=jimpl)
    b = gas.gas_scatter(_t(dst), _t(vals), n_rows, op=op, impl=impl)
    assert b.dtype == _t(vals).dtype
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_gather_ticks_find_and_equals_take(impl):
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    ids = np.array([3, 0, 9, 3], np.int32)
    with jgas.count_dispatches() as jc:
        a = jgas.gas_gather(jnp.asarray(table), jnp.asarray(ids),
                            impl={"ref": "xla", "kernel": "pallas"}[impl])
    with gas.count_dispatches() as tc:
        b = gas.gas_gather(_t(table), _t(ids), impl=impl)
    assert dict(jc) == dict(tc) == {"find": 1}
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_kernel_gather_needs_a_2d_table_and_impl_names_are_checked():
    with pytest.raises(NotImplementedError):
        gas.gas_gather(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                       impl="kernel")
    for bad in ("xla", "pallas"):
        with pytest.raises(ValueError, match="ref"):
            gas.gas_scatter(torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, 3), 4, impl=bad)
