"""Port parity: minibatch GraphSAGE forward (``core/gcn.py``).

Parameters are made by the JAX package and carried across with
``params_from_jax``; the feature table and the batch are numpy arrays both
packages take as they are. Logits must match within rtol = atol = 1e-5:
the aggregations are bit-exact on integer features, but the f32 matrix
products sum in a different order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common.schema import init_params as j_init_params
from repro.configs.graphic_gcn import PALLAS_CONFIG as J_PALLAS
from repro.core import gcn as jgcn
from repro.data.pipeline import GraphBatchStream as JGraphBatchStream
from repro.graph import uniform_graph
from repro_torch.common.schema import init_params
from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
from repro_torch.core import gas, gcn

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V, Fdim, H, C, K1, K2, B = 64, 24, 16, 5, 3, 4, 4


def _world(seed=0):
    g = uniform_graph(V, 4 * V, seed=seed)
    feats = np.random.default_rng(seed).integers(-3, 4, (1, V, Fdim)).astype(
        np.float32)
    labels = np.arange(V, dtype=np.int32) % C
    batch = JGraphBatchStream(g, labels, 1, B, k1=K1, k2=K2,
                              seed=seed).batch_at(0)
    return feats, batch


def _cfgs(**kw):
    knobs = dict(n_features=Fdim, hidden=H, n_classes=C, fanout=K2,
                 request_chunk=3)
    knobs.update(kw)
    jc = dataclasses.replace(J_PALLAS, **knobs)
    if "impl" in knobs:
        knobs["impl"] = {"xla": "ref", "pallas": "kernel"}[knobs["impl"]]
    return jc, dataclasses.replace(PALLAS_CONFIG, **knobs)


@pytest.mark.parametrize("kw", [
    {},                                           # the deployment
    {"coalesce": False},
    {"request_chunk": None, "scheduled": False},
    {"impl": "xla", "request_chunk": None, "scheduled": None},
    {"aggregate": "max"},
])
def test_sage_forward_matches_reference(kw):
    jc, tc = _cfgs(**kw)
    feats, batch = _world()
    jp = j_init_params(jgcn.gcn_schema(jc), jax.random.PRNGKey(0))
    with jgas_counts() as jcnt:
        a = jgcn.sage_forward(jp, jnp.asarray(feats),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jc)
    tp = gcn.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             device="cpu")
    with gas.count_dispatches() as tcnt:
        b = gcn.sage_forward(tp, torch.from_numpy(feats), batch, tc)
    assert b.shape == (1, B, C) and b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert dict(jcnt) == dict(tcnt)

    la, _ = jgcn.sage_loss(jp, jnp.asarray(feats),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    lb, metrics = gcn.sage_loss(tp, torch.from_numpy(feats), batch, tc)
    np.testing.assert_allclose(float(lb), float(la), **TOL)
    assert set(metrics) == {"loss", "acc"}


def jgas_counts():
    from repro.core import gas as jgas
    return jgas.count_dispatches()


def test_schema_and_params_from_jax_carry_every_tensor():
    jc, tc = _cfgs()
    jp = j_init_params(jgcn.gcn_schema(jc), jax.random.PRNGKey(1))
    schema = gcn.gcn_schema(tc)
    assert {k: d.shape for k, d in schema.items()} == {
        k: d.shape for k, d in jgcn.gcn_schema(jc).items()}
    tp = gcn.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             device="cpu")
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy())
    own = init_params(schema, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: d.shape for k, d in schema.items()}
    assert all(float(own[f"b{i}"].abs().sum()) == 0 for i in range(2))


def test_configs_mirror_the_reference():
    from repro.configs.graphic_gcn import CONFIG as J_CONFIG

    for name in ("n_features", "hidden", "n_classes", "fanout", "aggregate",
                 "dataflow", "n_layers", "request_chunk", "scheduled",
                 "coalesce", "wire", "features", "partition"):
        assert getattr(CONFIG, name) == getattr(J_CONFIG, name), name
        assert getattr(PALLAS_CONFIG, name) == getattr(J_PALLAS, name), name
    assert (CONFIG.impl, PALLAS_CONFIG.impl) == ("ref", "kernel")


def test_island_and_table2_configs_mirror_the_reference():
    from repro.configs import graphic_gcn as jcfgs
    from repro_torch.configs import graphic_gcn as tcfgs

    j, t = jcfgs.ISLAND_PALLAS_CONFIG, tcfgs.ISLAND_PALLAS_CONFIG
    assert t == dataclasses.replace(PALLAS_CONFIG, partition="island")
    assert t.partition == j.partition == "island"
    assert tcfgs.TABLE_II_GCN.keys() == jcfgs.TABLE_II_GCN.keys()
    for name, jc in jcfgs.TABLE_II_GCN.items():
        tc = tcfgs.TABLE_II_GCN[name]
        for f in dataclasses.fields(tc):
            if f.name != "impl":
                assert getattr(tc, f.name) == getattr(jc, f.name), (name,
                                                                    f.name)
        assert tc.impl == "ref"


def test_island_partition_raises():
    """``partition="island"`` without the relabel map raises the JAX
    package's ``ValueError`` (the knob and the map travel together)."""
    _, tc = _cfgs()
    feats, batch = _world()
    params = init_params(gcn.gcn_schema(tc), 0, device="cpu")
    with pytest.raises(ValueError, match="requires the IslandPartition"):
        gcn.sage_forward(params, torch.from_numpy(feats), batch,
                         dataclasses.replace(tc, partition="island"))
