"""Port parity: full-graph GCN, the compressed wire and compressed-sparse
features on ``torch.distributed``.

gloo ranks on the CPU (``repro_torch.launch.mesh.spawn``, one group per P
for the whole module) against the JAX package's unsharded result on the
same numpy inputs, computed in this process. JAX's own tiers hold its
sharded dataflows equal to the unsharded ones bit for bit on integer data,
so each rank's slice must equal the reference's slice:

* ``aggregate_edges`` for P in {2, 4}: both dataflows × add / max / min /
  or × ``impl`` ref and kernel, one ``edge_stream`` read by two
  aggregations, the feature table's and the edge weights' gradients (add
  bit for bit; max / min within 1e-5,
  their tie shares being thirds), the bf16 wire bit for bit (values and
  the add gradient), the int8 wire within the bound of the JAX package's
  ``test_mesh_int8_bounded``, sparse features alone and on the bf16 wire;
* ``gcn_forward_full`` for both dataflows × every op × both routes within
  1e-5;
* the sampled path (``aggregate_multi``) on the bf16 / int8 wires and on
  sparse features (both dataflows, and the baseline's packed shipment on
  the bf16 wire), with the int16 delta ids halving the request bytes;
* the serving engine on the bf16 wire against the unsharded engine;
* collective counts against ``analysis/budgets.py``, forward and forward
  + backward, the latter also against the JAX package's own grad program;
* per-rank bytes of the full-graph dataflows at
  ``tests/distributed_cases.py``'s full shape (8 ranks, V 256, E 4096,
  F 16) equal to the JAX package's HLO count taken live on 8 fake devices
  (``budgets.edges_bytes`` states the formula);
* a gradient through ``collectives.reduce_scatter`` equal to the
  all-gather of the cotangent;
* islandized ≡ interval (``partition="island"``) on a shuffled-id
  community graph, as ``tests/distributed_cases.py``'s
  ``case_islandized_parity`` holds it on 8 devices: ``aggregate_edges``
  on the island layout, un-permuted, bit for bit with the JAX package's
  unsharded interval result (both dataflows × add / max / min × both
  routes, and the add / max feature gradients); ``gcn_forward_full
  (relabel=)`` bit for bit with the unsharded port on integer data, its
  forward counts equal to ``budgets.gcn_full_forward`` and its
  ``relabel_gather`` bytes to the reference HLO's all-reduce;
  ``sage_forward`` and one train step island ≡ interval bit for bit (and
  within 1e-5 of the JAX step), and the engine with the hot cache on bit
  for bit with the JAX package's unsharded engine.

The ranks import ``torch`` and ``repro_torch`` only; JAX is imported only
inside the functions that compute the reference.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import budgets
from repro_torch.core import cgtrans, collectives, gas
from repro_torch.graph import partition_by_src, uniform_graph
from repro_torch.launch import mesh as meshlib

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores (every spawned rank sets the same).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
FLOWS = ("cgtrans", "baseline")
OPS = ("add", "max", "min", "or")
IMPLS = ("ref", "kernel")
JIMPL = {"ref": "xla", "kernel": "pallas"}
# F leaves the ReLU-like table room to pack (capacity 24 + 2 bitmap words
# < 40), so no sparse run falls back to dense
PART, F, HIDDEN, CLASSES = 32, 40, 16, 4
SEGMENTS = ((6, 1), (6, 4))          # the sage pair: K=1 lookup + fan-out
TOL = dict(rtol=1e-5, atol=1e-5)
# (dataflow, wire, features) of the sampled-path runs
SAMPLED = (("cgtrans", "bf16", "dense"), ("cgtrans", "int8", "dense"),
           ("cgtrans", "bf16", "sparse"), ("baseline", "f32", "sparse"),
           ("baseline", "bf16", "sparse"))
# (dataflow, wire) of the full-graph sparse runs
EDGE_SPARSE = (("cgtrans", "f32"), ("cgtrans", "bf16"), ("baseline", "f32"))


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _world(P):
    """Integer-valued feats in [-4, 4] and weights in [-2, 2] (every
    partial sum an integer below 256, so the bf16 wire is exact), the
    float feats and weights of the same graph, a ReLU-like copy for the
    sparse runs, and the sampled pair with power-of-two valid counts."""
    g = uniform_graph(PART * P, 8 * PART * P, seed=P, n_features=F,
                      weights=True)
    pg = partition_by_src(g, P)
    rng = np.random.default_rng(P)
    ints = rng.integers(-4, 5, pg.features.shape).astype(np.float32)
    relu = np.where(ints > 1, ints, 0).astype(np.float32)   # ~1/3 dense
    blocks = []
    for R, K in SEGMENTS:
        nbrs = rng.integers(0, P * PART, (P, R, K)).astype(np.int32)
        valid = rng.choice([0, 1, 2, K], (P, R)) if K > 1 else \
            (rng.random((P, R)) < 0.8).astype(int)
        mask = rng.random((P, R, K)).argsort(-1) < valid[..., None]
        blocks.append((nbrs, mask))
    from repro_torch.core.sparse import sparse_fits, table_capacity
    assert sparse_fits(table_capacity(relu), F)
    return {
        "ints": ints, "floats": pg.features.astype(np.float32),
        "relu": relu, "cap": table_capacity(relu),
        "src": pg.src, "dst": pg.dst, "mask": pg.mask,
        "w_int": rng.integers(-2, 3, pg.weights.shape).astype(np.float32),
        "w_float": pg.weights,
        "u": rng.integers(-3, 4, pg.features.shape).astype(np.float32),
        "blocks": blocks,
        "us": [rng.integers(-3, 4, (P, R, F)).astype(np.float32)
               for R, _ in SEGMENTS],
    }


ISLAND_OPS = ("add", "max", "min")
IB, IK = 4, 3                         # sampled path: seeds per rank, fan-out


def _island_world(P):
    """``case_islandized_parity``'s world at V = PART·P: a clustered graph
    with shuffled ids and deduplicated edges, and per-column injective
    integer features, so every max / min has one winner and every
    gradient is an integer; both layouts, the island map, small-integer
    features and parameters for ``gcn_forward_full``, a sampled batch and
    an integer serving table."""
    from repro_torch.core.gcn import GCNConfig, gcn_schema
    from repro_torch.graph import COOGraph, clustered_graph, partition_graph

    V = PART * P
    g0 = clustered_graph(V, 8 * V, n_clusters=2 * P, p_intra=0.9,
                         seed=10 + P)
    rng = np.random.default_rng(20 + P)
    perm = rng.permutation(V).astype(np.int32)
    pairs = np.unique(np.stack([perm[g0.src], perm[g0.dst]], 1), axis=0)
    feats = ((np.arange(V)[:, None] - V // 2 + np.arange(F)[None, :])
             * np.where(np.arange(F) % 2 == 0, 1.0, -1.0)).astype(np.float32)
    g = COOGraph(V, pairs[:, 0].astype(np.int32),
                 pairs[:, 1].astype(np.int32), None, feats)
    pg_i, _ = partition_graph(g, P, method="interval")
    pg_s, isl = partition_graph(g, P, method="island")
    assert pg_i.part_size == pg_s.part_size == PART
    u = rng.integers(-3, 4, (V, F)).astype(np.float32)
    small = rng.integers(-2, 3, (V, F)).astype(np.float32)
    gcot = rng.integers(-2, 3, (V, CLASSES)).astype(np.float32)
    schema = gcn_schema(GCNConfig(n_features=F, hidden=HIDDEN,
                                  n_classes=CLASSES))
    out = {"relabel": isl.relabel, "inverse": isl.inverse, "V": V,
           "gparams": {k: rng.integers(-1, 2, d.shape).astype(np.float32)
                       for k, d in schema.items()},
           "indptr_indices": g.to_csr()[:2],
           "serve": rng.integers(-5, 6, (V, F)).astype(np.float32)}
    for name, pg, order in (("interval", pg_i, None), ("island", pg_s,
                                                       isl.inverse)):
        rows = (lambda x: x) if order is None else (lambda x: x[order])
        pad = lambda x: np.concatenate(  # noqa: E731
            [rows(x), np.zeros((P * PART - V,) + x.shape[1:], x.dtype)]
        ).reshape((P, PART) + x.shape[1:])
        out[name] = {"feats": pg.features, "src": pg.src, "dst": pg.dst,
                     "w": pg.weights, "mask": pg.mask, "u": pad(u),
                     "small": pad(small)}
    # the cotangent of the logits, which come back in original order
    out["interval"]["gcot"] = np.concatenate(
        [gcot, np.zeros((P * PART - V, CLASSES), np.float32)]).reshape(
            P, PART, CLASSES)
    K = IK
    out["batch"] = {
        "seeds": rng.integers(0, V, (P, IB)).astype(np.int32),
        "nbrs1": rng.integers(0, V, (P, IB, K)).astype(np.int32),
        "mask1": rng.random((P, IB, K)) < 0.8,
        "nbrs2": rng.integers(0, V, (P, IB * (1 + K), K)).astype(np.int32),
        "mask2": rng.random((P, IB * (1 + K), K)) < 0.8,
        "labels": rng.integers(0, CLASSES, (P, IB)).astype(np.int32)}
    return out


def _island_tc(TrainConfig):
    return TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=1,
                       weight_decay=0.0)


def _gcn_cfg(lib, op, impl, flow="cgtrans"):
    return lib.GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                         aggregate=op, impl=impl, dataflow=flow)


def _serving_world():
    V = 64
    g = uniform_graph(V, 6 * V, seed=4)
    indptr, indices, _ = g.to_csr()
    feats = np.random.default_rng(2).integers(-5, 6, (V, F)).astype(
        np.float32)
    return feats, indptr, indices


# ---------------------------------------------------------------------------
# the reference, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The JAX package's unsharded results per P, computed once."""
    cache = {}

    def get(P):
        if P not in cache:
            cache[P] = _reference(P)
        return cache[P]
    return get


def _reference(P):
    import jax
    import jax.numpy as jnp

    from repro.common.schema import init_params
    from repro.core import cgtrans as jcg
    from repro.core import gcn as jgcn

    w = _world(P)
    J = {k: jnp.asarray(w[k]) for k in ("ints", "floats", "relu", "src",
                                        "dst", "mask", "w_int", "w_float",
                                        "u")}
    edges = lambda f, wt, **kw: jcg.aggregate_edges(  # noqa
        f, J["src"], J["dst"], wt, J["mask"], **kw)
    out = {"params": {}}
    for impl in IMPLS:
        for op in OPS:
            out[("edges", op, impl)] = np.asarray(
                edges(J["ints"], J["w_int"], op=op, impl=JIMPL[impl]))
            cfg = _gcn_cfg(jgcn, op, JIMPL[impl])
            params = init_params(jgcn.gcn_schema(cfg), jax.random.PRNGKey(0))
            out["params"] = jax.tree.map(np.asarray, params)
            out[("gcn", op, impl)] = np.asarray(jgcn.gcn_forward_full(
                params, J["floats"], J["src"], J["dst"], J["w_float"],
                J["mask"], cfg))
        for op in ("add", "max"):
            def loss(f, wt, op=op, impl=impl):
                o = edges(f, wt, op=op, impl=JIMPL[impl])
                return jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0) * J["u"])
            out[("edges_grad", op, impl)] = tuple(
                np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
                    J["ints"], J["w_int"]))
        out[("edges_relu", impl)] = np.asarray(
            edges(J["relu"], J["w_int"], impl=JIMPL[impl]))
    for op in ("add", "max"):
        out[("edges_float", op)] = np.asarray(
            edges(J["floats"], J["w_float"], op=op))
    blocks = [(jnp.asarray(n), jnp.asarray(m)) for n, m in w["blocks"]]
    for op in ("add", "max"):
        out[("multi", op)] = [np.asarray(o) for o in jcg.aggregate_multi(
            J["relu"], blocks, op=op)]
        out[("multi_float", op)] = [np.asarray(o) for o in
                                    jcg.aggregate_multi(J["floats"], blocks,
                                                        op=op)]

    def mloss(f):
        return sum((o * jnp.asarray(u)).sum() for o, u in zip(
            jcg.aggregate_multi(f, blocks), w["us"]))
    out["multi_grad"] = np.asarray(jax.grad(mloss)(J["relu"]))
    out["island"] = _island_reference(P, out["params"])
    return out


def _island_reference(P, params):
    """The JAX package's unsharded results on the interval layout of
    ``_island_world(P)``, in original vertex order."""
    import jax
    import jax.numpy as jnp

    from repro.common.config import TrainConfig as JTrainConfig
    from repro.core import cgtrans as jcg
    from repro.core import gcn as jgcn
    from repro.optim import adamw_init
    from repro.serving import ServingEngine as JServingEngine
    from repro.train import make_sage_train_step

    iw = _island_world(P)
    V, lay = iw["V"], iw["interval"]
    J = {k: jnp.asarray(v) for k, v in lay.items()}
    out = {}
    flat = lambda x: np.asarray(x).reshape(P * PART, -1)[:V]  # noqa: E731
    for impl in IMPLS:
        for op in ISLAND_OPS:
            out[("edges", op, impl)] = flat(jcg.aggregate_edges(
                J["feats"], J["src"], J["dst"], J["w"], J["mask"], op=op,
                impl=JIMPL[impl]))
        for op in ("add", "max"):
            def loss(f, op=op, impl=impl):
                o = jcg.aggregate_edges(f, J["src"], J["dst"], J["w"],
                                        J["mask"], op=op, impl=JIMPL[impl])
                return jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0) * J["u"])
            out[("grad", op, impl)] = flat(jax.grad(loss)(J["feats"]))
    cfg = jgcn.GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                         fanout=IK, impl="pallas")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    batch = {k: jnp.asarray(v) for k, v in iw["batch"].items()}
    out["sage"] = np.asarray(jgcn.sage_forward(jp, J["small"], batch, cfg))
    tc = _island_tc(JTrainConfig)
    state = {"params": jp, "opt": adamw_init(jp, tc),
             "step": jnp.zeros((), jnp.int32)}
    state, _ = make_sage_train_step(cfg, tc, feats=J["small"])(state, batch)
    out["train"] = jax.tree.map(np.asarray, state["params"])
    eng = JServingEngine(iw["serve"], *iw["indptr_indices"],
                         **_island_engine_kw())
    out["engine"] = _island_serve(eng, V)
    return out


def _island_engine_kw():
    return dict(fanout=4, max_batch=8, max_delay_s=1e9, cache_capacity=32)


def _island_serve(eng, V):
    """Two waves of single-seed requests (the second hits the cache):
    each request's (self rows, aggregated rows, from_cache)."""
    seeds = [s % V for s in (3, 9, 3, 17, 40, 9, 77, 130)]
    res = []
    for _wave in range(2):
        rids = [eng.submit([s]) for s in seeds]
        eng.flush()
        res += [(x.self_rows, x.agg_rows, x.from_cache)
                for x in map(eng.result, rids)]
    return res


# ---------------------------------------------------------------------------
# the ranks (torch and repro_torch only)
# ---------------------------------------------------------------------------

def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _counted(fn):
    with collectives.count_collectives() as c, gas.count_dispatches() as d:
        out = fn()
    return out, {**c.as_dict(), **{k: v for k, v in d.items() if v}}, \
        dict(c.bytes)


def _rank(mesh, world, params, serving):
    from repro_torch.core.gcn import GCNConfig, gcn_forward_full

    r = mesh.rank
    mine = lambda k: torch.from_numpy(np.ascontiguousarray(  # noqa
        world[k][r:r + 1]))
    src, dst, mask = mine("src"), mine("dst"), mine("mask")
    ints, floats, relu = mine("ints"), mine("floats"), mine("relu")
    w_int, w_float, u = mine("w_int"), mine("w_float"), mine("u")
    V = mesh.size * PART
    out = {}

    def edges(f, wt, **kw):
        return cgtrans.aggregate_edges(f, src, dst, wt, mask, mesh=mesh,
                                       **kw)

    for flow in FLOWS:
        for impl in IMPLS:
            for op in OPS:
                o, c, b = _counted(lambda: edges(ints, w_int, dataflow=flow,
                                                 op=op, impl=impl))
                out[("edges", flow, op, impl)] = (o.numpy(), c, b)
            for op in ("add", "max"):
                f = ints.clone().requires_grad_(True)
                wt = w_int.clone().requires_grad_(True)

                def fwd_bwd():
                    o = edges(f, wt, dataflow=flow, op=op, impl=impl)
                    (torch.where(torch.isfinite(o), o, torch.zeros(()))
                     * u).sum().backward()
                _, c, _ = _counted(fwd_bwd)
                out[("edges_grad", flow, op, impl)] = (
                    f.grad.numpy(), torch.zeros_like(wt).numpy()
                    if wt.grad is None else wt.grad.numpy(), c)
            for op in OPS:
                cfg = GCNConfig(n_features=F, hidden=HIDDEN,
                                n_classes=CLASSES, aggregate=op, impl=impl,
                                dataflow=flow)
                p = {k: torch.from_numpy(v) for k, v in params.items()}
                out[("gcn", flow, op, impl)] = gcn_forward_full(
                    p, floats, src, dst, w_float, mask, cfg,
                    mesh=mesh).detach().numpy()

    # the fused route (the banded walk reading the table) against the
    # gather and the scatter called directly, on normal data: the result
    # and the feature and weight gradients; and where the route engages
    from repro_torch.runtime import trace
    fused_vs = {}
    for fused in (True, False):
        f = floats.clone().requires_grad_(True)
        wt = w_float.clone().requires_grad_(True)
        st = cgtrans.edge_stream(src, dst, wt, mask, f.shape[:2], mesh=mesh,
                                 impl="kernel")
        if fused:
            o = cgtrans.aggregate_stream(f, st, impl="kernel")
        else:
            o = collectives.reduce_scatter(gas.gas_scatter_weighted(
                st.dst, gas.gas_gather(f[0], st.src, impl="kernel"),
                st.weights, st.mask, st.n_rows, op="add", impl="kernel",
                schedule=st.schedule).reshape(mesh.size, PART, F), mesh)[None]
        (o * u).sum().backward()
        fused_vs[fused] = [x.detach().numpy() for x in (o, f.grad, wt.grad)]
    out["fused_vs_composition"] = fused_vs
    with trace.recording():
        for flow in FLOWS:
            trace.reset()
            edges(floats, w_float, dataflow=flow, impl="kernel")
            out[("fused_count", flow)] = trace.summary()["counters"].get(
                "gas.find.fused", 0)
        trace.reset()

    # the schedule paid once at partition time, per rank, and one stream
    # over it read by two aggregations
    sched = cgtrans.build_edge_schedule(dst, mask, V, mesh=mesh)
    stream = cgtrans.edge_stream(src, dst, w_int, mask, ints.shape[:2],
                                 mesh=mesh, impl="kernel", schedule=sched)
    for op in ("add", "max"):
        out[("stream", op)] = cgtrans.aggregate_stream(
            ints, stream, op=op, impl="kernel").numpy()

    # the compressed wire on the full-graph cgtrans combine
    for impl in IMPLS:
        for wire in ("bf16", "int8"):
            for op in ("add", "max"):
                data = (ints, w_int) if wire == "bf16" else (floats, w_float)
                o, c, b = _counted(lambda: edges(*data, op=op, impl=impl,
                                                 wire=wire))
                out[("edges_wire", wire, op, impl)] = (o.numpy(), c, b)
        f = ints.clone().requires_grad_(True)
        wt = w_int.clone().requires_grad_(True)

        def fwd_bwd_bf16():
            (edges(f, wt, impl=impl, wire="bf16") * u).sum().backward()
        _, c, _ = _counted(fwd_bwd_bf16)
        out[("edges_wire_grad", impl)] = (f.grad.numpy(), wt.grad.numpy(), c)
        # sparse features on the full-graph gather
        for flow, wire in EDGE_SPARSE:
            o, c, _ = _counted(lambda: edges(
                relu, w_int, dataflow=flow, impl=impl, wire=wire,
                features="sparse", sparse_capacity=world["cap"]))
            out[("edges_sparse", flow, wire, impl)] = (o.numpy(), c)

    # the sampled path with the wire and sparse features
    blocks = [(mine_b[0], mine_b[1]) for mine_b in (
        (torch.from_numpy(np.ascontiguousarray(n[r:r + 1])),
         torch.from_numpy(np.ascontiguousarray(m[r:r + 1])))
        for n, m in world["blocks"])]
    for flow, wire, feats_mode in SAMPLED:
        kw = dict(mesh=mesh, dataflow=flow, wire=wire, features=feats_mode,
                  sparse_capacity=world["cap"] if feats_mode == "sparse"
                  else None, impl="kernel")
        table = floats if wire == "int8" else relu
        for op in ("add", "max"):
            o, c, b = _counted(lambda: cgtrans.aggregate_multi(
                table, blocks, op=op, **kw))
            out[("multi", flow, wire, feats_mode, op)] = (
                [x.numpy() for x in o], c, b)
    out["multi_f32_bytes"] = {flow: _counted(lambda: cgtrans.aggregate_multi(
        relu, blocks, mesh=mesh, dataflow=flow))[2] for flow in FLOWS}
    f = relu.clone().requires_grad_(True)
    us = [torch.from_numpy(np.ascontiguousarray(x[r:r + 1]))
          for x in world["us"]]

    def multi_bwd():
        outs = cgtrans.aggregate_multi(f, blocks, mesh=mesh, wire="bf16",
                                       impl="kernel")
        sum((o * x).sum() for o, x in zip(outs, us)).backward()
    _, c, _ = _counted(multi_bwd)
    out["multi_grad"] = (f.grad.numpy(), c)

    # reduce_scatter's gradient: the all_gather of the cotangent
    x = (torch.arange(mesh.size * 6, dtype=torch.float32).reshape(
        mesh.size, 3, 2) + 100 * r).requires_grad_(True)
    g = torch.arange(6, dtype=torch.float32).reshape(3, 2) * (r + 1)
    (y, c, _) = _counted(lambda: collectives.reduce_scatter(x, mesh))
    _, cb, _ = _counted(lambda: (y * g).sum().backward())
    out["reduce_scatter"] = (y.detach().numpy(), x.grad.numpy(), c, cb)

    if serving is not None:
        from repro_torch.serving import ServingEngine
        res = {}
        for wire in ("f32", "bf16"):
            eng = _engine(ServingEngine, *serving, mesh=mesh, wire=wire)
            rids = [eng.submit([s, s + 3], tenant=s % 3) for s in range(8)]
            _, c, b = _counted(eng.flush)
            res[wire] = ([(x.self_rows, x.agg_rows)
                          for x in map(eng.result, rids)], c, b)
        out["engine"] = res
    out["island"] = _island_rank(mesh, world["island"], params)
    out["modules"] = _foreign_modules()
    return out


def _island_rank(mesh, iw, params):
    """This rank's islandized runs (and the interval twins of the sampled
    path), with the counts of the un-permuting forward."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.core.gcn import GCNConfig, gcn_forward_full, sage_forward
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.train import make_sage_train_step

    r = mesh.rank
    lay = {k: torch.from_numpy(np.ascontiguousarray(v[r:r + 1]))
           for k, v in iw["island"].items()}
    edges = (lay["src"], lay["dst"], lay["w"], lay["mask"])
    cot = torch.from_numpy(np.ascontiguousarray(
        iw["interval"]["gcot"][r:r + 1]))
    rl = iw["relabel"]
    out = {}
    for flow in FLOWS:
        for impl in IMPLS:
            for op in ISLAND_OPS:
                out[("edges", flow, op, impl)] = cgtrans.aggregate_edges(
                    lay["feats"], *edges, mesh=mesh, dataflow=flow, op=op,
                    impl=impl).numpy()
            for op in ("add", "max"):
                f = lay["feats"].clone().requires_grad_(True)
                o = cgtrans.aggregate_edges(f, *edges, mesh=mesh,
                                            dataflow=flow, op=op, impl=impl)
                (torch.where(torch.isfinite(o), o, torch.zeros(()))
                 * lay["u"]).sum().backward()
                out[("grad", flow, op, impl)] = f.grad.numpy()
            cfg = GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                            impl=impl, dataflow=flow, partition="island")
            p = {k: torch.from_numpy(v).requires_grad_(True)
                 for k, v in iw["gparams"].items()}
            with torch.no_grad():
                o, c, b = _counted(lambda: gcn_forward_full(
                    p, lay["small"], *edges, cfg, mesh=mesh, relabel=rl))
            # the un-permuted logits are in original vertex order, and so
            # is their cotangent
            (gcn_forward_full(p, lay["small"], *edges, cfg, mesh=mesh,
                              relabel=rl) * cot).sum().backward()
            out[("gcn", flow, impl)] = (o.numpy(), c, b, {
                k: v.grad.numpy() for k, v in p.items()})
    # the sampled path: island and interval twins on this rank
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[r:r + 1]))
             for k, v in iw["batch"].items()}
    tables = {"interval": torch.from_numpy(np.ascontiguousarray(
                  iw["interval"]["small"][r:r + 1])),
              "island": lay["small"]}
    tc = _island_tc(TrainConfig)
    for layout in ("interval", "island"):
        cfg = GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                        fanout=IK, impl="kernel", partition=layout)
        relabel = rl if layout == "island" else None
        # a copy: the train step below updates its parameters in place
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        with torch.no_grad():
            out[("sage", layout)] = sage_forward(
                tp, tables[layout], batch, cfg, mesh=mesh,
                relabel=relabel).numpy()
        state = {"params": tp, "opt": adamw_init(tp, tc),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, _ = make_sage_train_step(cfg, tc, feats=tables[layout],
                                        mesh=mesh, relabel=relabel)(
            state, batch)
        out[("train", layout)] = {k: v.numpy()
                                  for k, v in state["params"].items()}
        t = [0.0]

        def clock():
            t[0] += 0.001
            return t[0]
        eng = ServingEngine(iw["serve"], *iw["indptr_indices"], mesh=mesh,
                            partition=layout, clock=clock, device="cpu",
                            impl="kernel", **_island_engine_kw())
        out[("engine", layout)] = (_island_serve(eng, iw["V"]),
                                   eng.cache.snapshot())
    return out


def _engine(ServingEngine, feats, indptr, indices, **kw):
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    return ServingEngine(feats, indptr, indices, fanout=4, max_batch=8,
                         clock=clock, sample_seed=0, device="cpu",
                         impl="kernel", **kw)


@pytest.fixture(scope="module")
def sharded(reference):
    cache = {}

    def get(P):
        if P not in cache:
            cache[P] = meshlib.spawn(
                _rank, P, backend="gloo", device="cpu", timeout_s=TIMEOUT_S,
                args=({**_world(P), "island": _island_world(P)},
                      reference(P)["params"],
                      _serving_world() if P == 2 else None))
        return cache[P]
    return get


def _slices(sharded, P):
    return list(enumerate(sharded(P)))


# ---------------------------------------------------------------------------
# aggregate_edges
# ---------------------------------------------------------------------------

_EDGES = [(P, flow, op, impl) for P in (2, 4) for flow in FLOWS
          for op in OPS for impl in IMPLS]


@pytest.mark.parametrize("P,flow,op,impl", _EDGES)
def test_sharded_aggregate_edges_matches_reference(sharded, reference, P,
                                                   flow, op, impl):
    want = reference(P)[("edges", op, impl)]
    budget = budgets.edges_forward(flow, op, impl)
    for r, res in _slices(sharded, P):
        got, counts, nbytes = res[("edges", flow, op, impl)]
        np.testing.assert_array_equal(got, want[r:r + 1])
        assert counts == budget


@pytest.mark.parametrize("P,op", [(P, op) for P in (2, 4)
                                  for op in ("add", "max")])
def test_edge_stream_matches_reference(sharded, reference, P, op):
    """A stream built once per rank over a prebuilt schedule, read by an
    add and then a max aggregation: bit for bit the reference."""
    want = reference(P)[("edges", op, "kernel")]
    for r, res in _slices(sharded, P):
        np.testing.assert_array_equal(res[("stream", op)], want[r:r + 1])


@pytest.mark.parametrize("P", (2, 4))
def test_fused_route_equals_the_composition_on_a_mesh(sharded, P):
    """On each rank of the cgtrans mesh the fused route's result, feature
    gradient and weight gradient equal the gather and the scatter called
    directly, bit for bit on normal data; it engages once an aggregation
    there and never on the baseline, which gathers before it ships."""
    for _, res in _slices(sharded, P):
        for a, b in zip(*(res["fused_vs_composition"][k]
                          for k in (True, False))):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        assert np.abs(res["fused_vs_composition"][True][2]).sum() > 0
        assert res[("fused_count", "cgtrans")] == 1
        assert res[("fused_count", "baseline")] == 0


@pytest.mark.parametrize("P,flow,op,impl", [
    (P, flow, op, impl) for P in (2, 4) for flow in FLOWS
    for op in ("add", "max") for impl in IMPLS])
def test_sharded_edges_gradients_match_reference(sharded, reference,
                                                 reference_programs, P, flow,
                                                 op, impl):
    """d/dfeats and d/dweights: add bit for bit against the unsharded
    reference, max within 1e-5 (tied edges share a cell as g / ties). The
    cgtrans max combine splits a cotangent among tied shards before tied
    edges, as the reference's own sharded program does, so it is held
    against that program's gradient; baseline reduces every edge at the
    destination, as unsharded. Forward + backward collectives equal
    ``EDGES_BWD`` (held against the reference's grad program below)."""
    jf, jw = reference(P)[("edges_grad", op, impl)]
    if (flow, op) == ("cgtrans", "max"):
        jf, jw = (np.asarray(x, np.float32) for x in
                  reference_programs[f"max_grad/{P}/{JIMPL[impl]}"])
    wf = np.concatenate([res[("edges_grad", flow, op, impl)][0]
                         for _, res in _slices(sharded, P)])
    ww = np.concatenate([res[("edges_grad", flow, op, impl)][1]
                         for _, res in _slices(sharded, P)])
    if op == "add":
        np.testing.assert_array_equal(wf, jf)
        np.testing.assert_array_equal(ww, jw)
    else:
        np.testing.assert_allclose(wf, jf, **TOL)
        np.testing.assert_allclose(ww, jw, **TOL)
    want = budgets.EDGES_BWD[(flow, op)]
    for _, res in _slices(sharded, P):
        counts = res[("edges_grad", flow, op, impl)][2]
        assert {k: v for k, v in counts.items()
                if k in budgets.COLLECTIVE_KEYS} == want


@pytest.mark.parametrize("P,op,impl", [(P, op, impl) for P in (2, 4)
                                       for op in ("add", "max")
                                       for impl in IMPLS])
def test_bf16_wire_is_bit_exact(sharded, reference, P, op, impl):
    want = reference(P)[("edges", op, impl)]
    budget = budgets.edges_forward("cgtrans", op, impl, "bf16")
    for r, res in _slices(sharded, P):
        got, counts, nbytes = res[("edges_wire", "bf16", op, impl)]
        np.testing.assert_array_equal(got, want[r:r + 1])
        assert counts == budget
        assert sum(nbytes.values()) == budgets.edges_bytes(
            "cgtrans", "bf16", P, PART, F, 0)


@pytest.mark.parametrize("P,impl", [(P, impl) for P in (2, 4)
                                    for impl in IMPLS])
def test_bf16_wire_gradients_are_bit_exact(sharded, reference, P, impl):
    """The cotangent ships through the same wire (integers below 256)."""
    jf, jw = reference(P)[("edges_grad", "add", impl)]
    res = sharded(P)
    np.testing.assert_array_equal(
        np.concatenate([x[("edges_wire_grad", impl)][0] for x in res]), jf)
    np.testing.assert_array_equal(
        np.concatenate([x[("edges_wire_grad", impl)][1] for x in res]), jw)
    for x in res:
        counts = x[("edges_wire_grad", impl)][2]
        collected = {k: v for k, v in counts.items()
                     if k in budgets.COLLECTIVE_KEYS}
        assert collected == budgets.EDGES_BWD_NARROW_ADD


@pytest.mark.parametrize("P,op,impl", [(P, op, impl) for P in (2, 4)
                                       for op in ("add", "max")
                                       for impl in IMPLS])
def test_int8_wire_is_bounded(sharded, reference, P, op, impl):
    """The JAX package's ``test_mesh_int8_bounded`` rule: identity cells
    agree exactly, the rest within 2 % of the payload's span."""
    want = reference(P)[("edges_float", op)]
    for r, res in _slices(sharded, P):
        got, counts, nbytes = res[("edges_wire", "int8", op, impl)]
        w = want[r:r + 1]
        assert (np.isfinite(got) == np.isfinite(w)).all()
        fin = np.isfinite(w)
        span = np.abs(w[fin]).max()
        assert np.abs(got[fin] - w[fin]).max() <= 0.02 * span + 1e-6
        assert counts == budgets.edges_forward("cgtrans", op, impl, "int8")
        assert sum(nbytes.values()) == budgets.edges_bytes(
            "cgtrans", "int8", P, PART, F, 0)


@pytest.mark.parametrize("P,flow,wire,impl", [
    (P, flow, wire, impl) for P in (2, 4) for flow, wire in EDGE_SPARSE
    for impl in IMPLS])
def test_sparse_edges_equal_dense(sharded, reference, P, flow, wire, impl):
    """Sparse features change the gather, not the result or the budget
    (the reference's ``aggregate_edges/cgtrans/add/xla/sparse`` row)."""
    want = reference(P)[("edges_relu", impl)]
    budget = budgets.edges_forward(flow, "add", impl, wire)
    if (flow, wire) == ("cgtrans", "f32"):
        assert {k: v for k, v in budget.items() if k != "kernel_scatter"} \
            == budgets.EDGES_FWD_SPARSE_ADD
    for r, res in _slices(sharded, P):
        got, counts = res[("edges_sparse", flow, wire, impl)]
        np.testing.assert_array_equal(got, want[r:r + 1])
        assert counts == budget


# ---------------------------------------------------------------------------
# gcn_forward_full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,flow,op,impl", _EDGES)
def test_sharded_gcn_forward_full_matches_reference(sharded, reference, P,
                                                    flow, op, impl):
    want = reference(P)[("gcn", op, impl)]
    for r, res in _slices(sharded, P):
        np.testing.assert_allclose(res[("gcn", flow, op, impl)],
                                   want[r:r + 1], **TOL)


# ---------------------------------------------------------------------------
# the sampled path on the wire and on sparse features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,flow,wire,features,op", [
    (P, *run, op) for P in (2, 4) for run in SAMPLED
    for op in ("add", "max")])
def test_sampled_wire_and_sparse_match_reference(sharded, reference, P, flow,
                                                 wire, features, op):
    """bf16 and sparse bit for bit, int8 within the reference's bound; the
    collectives and dispatches of the f32 dense twin (``MULTI_FWD``); the
    int16 delta ids halve the request bytes."""
    key = ("multi_float", op) if wire == "int8" else ("multi", op)
    want = reference(P)[key]
    budget = {**budgets.held(budgets.MULTI_FWD[flow]),
              "kernel_scatter": budgets.MULTI_FWD[flow]["reduce"]}
    for r, res in _slices(sharded, P):
        got, counts, nbytes = res[("multi", flow, wire, features, op)]
        for g, w in zip(got, want):
            w = w[r:r + 1]
            if wire == "int8":
                span = np.abs(w).max()
                assert np.abs(g - w).max() <= 0.02 * span + 1e-6
            else:
                np.testing.assert_array_equal(g, w)
        assert counts == budget
        f32 = res["multi_f32_bytes"][flow]
        if wire != "f32":
            assert 2 * nbytes["all_gather"] == f32["all_gather"]
        if features == "sparse" and flow == "baseline":
            # the raw rows ship packed: capacity + bitmap lanes, not F
            assert nbytes["all_to_all"] < f32["all_to_all"]


@pytest.mark.parametrize("P", [2, 4])
def test_sampled_bf16_gradient_is_bit_exact(sharded, reference, P):
    want = reference(P)["multi_grad"]
    res = sharded(P)
    np.testing.assert_array_equal(
        np.concatenate([x["multi_grad"][0] for x in res]), want)
    budget = budgets.held(budgets.MULTI_BWD["cgtrans"],
                          budgets.MULTI_BWD_PALLAS["cgtrans"])
    for x in res:
        assert x["multi_grad"][1] == budget


def test_engine_on_the_bf16_wire_equals_the_unsharded_engine(sharded):
    """Two ranks on the bf16 wire serve what the unsharded engine serves,
    bit for bit, with the f32 engine's collectives and half its id
    bytes."""
    from repro_torch.serving import ServingEngine

    eng = _engine(ServingEngine, *_serving_world())
    rids = [eng.submit([s, s + 3], tenant=s % 3) for s in range(8)]
    eng.flush()
    want = [(x.self_rows, x.agg_rows) for x in map(eng.result, rids)]
    for res in sharded(2):
        rows, counts, nbytes = res["engine"]["bf16"]
        _, f32_counts, f32_bytes = res["engine"]["f32"]
        for (a, b), (c, d) in zip(rows, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        assert counts == f32_counts
        assert 2 * nbytes["all_gather"] == f32_bytes["all_gather"]
        assert nbytes["all_to_all"] < f32_bytes["all_to_all"]


@pytest.mark.parametrize("P", [2, 4])
def test_reduce_scatter_gradient_is_the_all_gather_of_the_cotangent(
        sharded, P):
    for r, res in _slices(sharded, P):
        y, grad, c, cb = res["reduce_scatter"]
        base = np.arange(P * 6, dtype=np.float32).reshape(P, 3, 2)
        np.testing.assert_array_equal(
            y, sum(base[r] + 100 * q for q in range(P)))
        # rank q's cotangent is g·(q + 1); d/dx[j] on every rank is rank
        # j's cotangent: the all_gather of the cotangents
        g = np.arange(6, dtype=np.float32).reshape(3, 2)
        np.testing.assert_array_equal(
            grad, np.stack([g * (q + 1) for q in range(P)]))
        assert c == {"psum_scatter": 1} and cb == {"all_gather": 1}


# ---------------------------------------------------------------------------
# islandized ≡ interval on the ranks
# ---------------------------------------------------------------------------

def _unpermute(rows, P):
    """The ranks' islandized (1, part, …) slices → original vertex order."""
    iw = _island_world(P)
    flat = np.concatenate(rows).reshape(P * PART, -1)
    return flat[iw["relabel"]]


@pytest.mark.parametrize("P,flow,op,impl", [
    (P, flow, op, impl) for P in (2, 4) for flow in FLOWS
    for op in ISLAND_OPS for impl in IMPLS])
def test_island_aggregate_edges_equals_interval_reference(sharded, reference,
                                                          P, flow, op, impl):
    got = _unpermute([res["island"][("edges", flow, op, impl)]
                      for res in sharded(P)], P)
    np.testing.assert_array_equal(got, reference(P)["island"][("edges", op,
                                                                impl)])


@pytest.mark.parametrize("P,flow,op,impl", [
    (P, flow, op, impl) for P in (2, 4) for flow in FLOWS
    for op in ("add", "max") for impl in IMPLS])
def test_island_edges_gradient_equals_interval_reference(sharded, reference,
                                                         P, flow, op, impl):
    """Every max has one winner (injective columns, no duplicate edge), so
    the gradient is exact in any order and on any layout."""
    got = _unpermute([res["island"][("grad", flow, op, impl)]
                      for res in sharded(P)], P)
    np.testing.assert_array_equal(got, reference(P)["island"][("grad", op,
                                                               impl)])


@pytest.mark.parametrize("P,flow,impl", [(P, flow, impl) for P in (2, 4)
                                         for flow in FLOWS for impl in IMPLS])
def test_island_gcn_forward_full_equals_the_unsharded_port(sharded, P, flow,
                                                           impl):
    """``gcn_forward_full(relabel=)`` on the ranks: each rank's slice of the
    un-permuted logits bit for bit with the unsharded port on the interval
    layout (integer data), the parameter gradients summed over ranks bit
    for bit, the forward's counts equal to ``budgets.gcn_full_forward`` and
    the un-permute's bytes to ``budgets.relabel_gather_bytes``."""
    from repro_torch.core.gcn import GCNConfig, gcn_forward_full

    iw = _island_world(P)
    lay = {k: torch.from_numpy(v) for k, v in iw["interval"].items()}
    cfg = GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                    impl=impl, dataflow=flow)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in iw["gparams"].items()}
    want = gcn_forward_full(p, lay["small"], lay["src"], lay["dst"],
                            lay["w"], lay["mask"], cfg)
    (want * lay["gcot"]).sum().backward()
    ranks = [res["island"][("gcn", flow, impl)] for res in sharded(P)]
    budget = budgets.gcn_full_forward(flow, "add", impl, cfg.n_layers,
                                      relabel=True)
    for r, (got, counts, nbytes, _) in enumerate(ranks):
        np.testing.assert_array_equal(got, want.detach().numpy()[r:r + 1])
        assert counts == budget
        assert nbytes["relabel_gather"] == budgets.relabel_gather_bytes(
            P, PART, CLASSES)
    for k, v in p.items():
        np.testing.assert_array_equal(sum(x[3][k] for x in ranks),
                                      v.grad.numpy(), err_msg=k)


@pytest.mark.parametrize("P", [2, 4])
def test_island_sage_forward_and_train_step_equal_interval(sharded,
                                                           reference, P):
    """The sampled path on the ranks: island ≡ interval bit for bit (the
    same rows fetched in the same order), logits and one step's
    parameters; both within 1e-5 of the JAX package's unsharded step."""
    want = reference(P)["island"]
    res = sharded(P)
    for layout in ("interval", "island"):
        got = np.concatenate([x["island"][("sage", layout)] for x in res])
        np.testing.assert_allclose(got, want["sage"], **TOL)
    for x in res:
        np.testing.assert_array_equal(x["island"][("sage", "island")],
                                      x["island"][("sage", "interval")])
        a, b = x["island"][("train", "island")], x["island"][("train",
                                                               "interval")]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a[k], want["train"][k], **TOL)


@pytest.mark.parametrize("P", [2, 4])
def test_island_engine_equals_the_reference_engine(sharded, reference, P):
    """``ServingEngine(partition="island")`` on the ranks, hot cache on:
    every request bit for bit with the interval ranks and with the JAX
    package's unsharded engine (integer table), the same cache
    behaviour, hits in the second wave."""
    want = reference(P)["island"]["engine"]
    for x in sharded(P):
        (isl, isl_cache), (itv, itv_cache) = (x["island"][("engine", k)]
                                              for k in ("island", "interval"))
        assert isl_cache == itv_cache and isl_cache["hits"] > 0
        for a, b, c in zip(isl, itv, want):
            for u, v, w in zip(a, b, c):
                np.testing.assert_array_equal(u, v)
                np.testing.assert_array_equal(u, w)


@pytest.mark.parametrize("P", [2, 4])
def test_ranks_import_neither_jax_nor_the_reference(sharded, P):
    for res in sharded(P):
        assert res["modules"] == []


# ---------------------------------------------------------------------------
# the reference's own programs: collective counts and bytes, live
# ---------------------------------------------------------------------------

_PROBE = r"""
import json, re
import jax, jax.numpy as jnp, numpy as np
from repro.core import cgtrans
from repro.graph import partition_by_src, uniform_graph
from repro.launch import hlo_analysis as H
from repro.launch.mesh import make_data_mesh
mesh = make_data_mesh(8)
g = uniform_graph(256, 4096, seed=1, n_features=16, weights=True)
pg = partition_by_src(g, 8)
args = (jnp.asarray(pg.features), jnp.asarray(pg.src), jnp.asarray(pg.dst),
        jnp.asarray(pg.weights), jnp.asarray(pg.mask))
NAMES = ("all_gather", "all_to_all", "psum", "reduce_scatter")
def count(fn, *a):
    txt = str(jax.make_jaxpr(fn)(*a))
    return {n: len(re.findall(r"\b%s\[" % n, txt)) for n in NAMES}
out = {"e_max": int(pg.src.shape[1])}
for flow, op, wire in PROBED:
    f = lambda *a, fl=flow, o=op, w=wire: cgtrans.aggregate_edges(
        *a, mesh=mesh, dataflow=fl, op=o, wire=w)
    key = "/".join((flow, op, wire))
    comp = jax.jit(f).lower(*args).compile()
    out["bytes/" + key] = H.analyze(comp.as_text()).collective_bytes
    def loss(feats, w, f=f):
        o = f(feats, args[1], args[2], w, args[4])
        return jnp.where(jnp.isfinite(o), o, 0).sum()
    out["grad/" + key] = count(jax.grad(loss, argnums=(0, 1)), args[0],
                               args[3])
# gcn_forward_full with and without the island un-permute: its collectives
import dataclasses
from repro.common.schema import init_params
from repro.core.gcn import GCNConfig, gcn_forward_full, gcn_schema
from repro.graph import partition_graph
pg_s, isl = partition_graph(g, 8, method="island")
a_s = tuple(jnp.asarray(x) for x in (pg_s.features, pg_s.src, pg_s.dst,
                                     pg_s.weights, pg_s.mask))
cfg = GCNConfig(n_features=16, hidden=16, n_classes=4)
gp = init_params(gcn_schema(cfg), jax.random.PRNGKey(0))
for name, rl in (("interval", None), ("island", isl.relabel)):
    c = dataclasses.replace(cfg, partition=name)
    comp = jax.jit(lambda p, *a, c=c, rl=rl: gcn_forward_full(
        p, *a, c, mesh=mesh, relabel=rl)).lower(gp, *a_s).compile()
    out["gcn_full/" + name] = {
        k: v for k, v in H.analyze(comp.as_text()).collectives.items()
        if v["count"]}
out["gcn_full/part"] = int(pg_s.part_size)
# the cgtrans max gradient on P of the devices: the cross-shard extremum
# splits a cotangent among tied shards first, then among tied edges
from jax.sharding import Mesh
for P in (2, 4):
    w = np.load(WORLD % P)
    sub = Mesh(np.array(jax.devices()[:P]), ("data",))
    for impl in ("xla", "pallas"):
        def loss(f, wt, impl=impl):
            o = cgtrans.aggregate_edges(f, jnp.asarray(w["src"]),
                                        jnp.asarray(w["dst"]), wt,
                                        jnp.asarray(w["mask"]), mesh=sub,
                                        op="max", impl=impl)
            return jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0)
                           * jnp.asarray(w["u"]))
        gf, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(w["ints"]), jnp.asarray(w["w_int"]))
        out[f"max_grad/{P}/{impl}"] = [np.asarray(gf).tolist(),
                                       np.asarray(gw).tolist()]
print(json.dumps(out))
"""
_PROBED = (("cgtrans", "add", "f32"), ("cgtrans", "max", "f32"),
           ("baseline", "add", "f32"), ("baseline", "max", "f32"),
           ("cgtrans", "add", "bf16"), ("cgtrans", "add", "int8"),
           ("cgtrans", "max", "bf16"))


@pytest.fixture(scope="module")
def reference_programs(tmp_path_factory):
    """The reference's grad-program collectives and HLO collective bytes of
    ``aggregate_edges`` on its own 8-device mesh, and its sharded cgtrans
    max gradient on 2 and 4 of them (a subprocess)."""
    tmp = tmp_path_factory.mktemp("edges_worlds")
    for P in (2, 4):
        w = _world(P)
        np.savez(tmp / f"world{P}.npz",
                 **{k: w[k] for k in ("ints", "src", "dst", "mask", "w_int",
                                      "u")})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = _PROBE.replace("PROBED", repr(_PROBED)).replace(
        "WORLD", repr(str(tmp / "world%d.npz")))
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("flow,op,wire", [k for k in _PROBED
                                          if k[2] != "int8"])
def test_edges_bwd_budget_is_the_reference_grad_program(reference_programs,
                                                        flow, op, wire):
    got = reference_programs[f"grad/{flow}/{op}/{wire}"]
    want = (budgets.EDGES_BWD_NARROW_ADD if (op, wire) == ("add", "bf16")
            else budgets.EDGES_BWD[(flow, op)])
    named = {"psum_scatter" if k == "reduce_scatter" else k: v
             for k, v in got.items() if v}
    assert named == want


def test_relabel_gather_is_the_reference_all_reduce(reference_programs):
    """What the JAX program adds for the un-permute of
    ``gcn_forward_full(relabel=)`` on its 8-device mesh: one all-reduce of
    the (8·part, C) logits — the collective the port's ``relabel_gather``
    stands for, with the bytes ``budgets.relabel_gather_bytes`` gives."""
    plain = reference_programs["gcn_full/interval"]
    island = reference_programs["gcn_full/island"]
    extra = {}
    for k, v in island.items():
        base = plain.get(k, {"count": 0.0, "bytes": 0.0})
        if v["count"] != base["count"]:
            extra[k] = {"count": v["count"] - base["count"],
                        "bytes": v["bytes"] - base["bytes"]}
    part = reference_programs["gcn_full/part"]
    assert extra == {"all-reduce": {
        "count": float(budgets.RELABEL_GATHER_PER_FORWARD),
        "bytes": float(budgets.relabel_gather_bytes(8, part, 4))}}


def _bytes_rank(mesh, world):
    r = mesh.rank
    mine = lambda x: torch.from_numpy(np.ascontiguousarray(x[r:r + 1]))  # noqa
    out = {}
    for flow, op, wire in _PROBED:
        with collectives.count_collectives() as c:
            cgtrans.aggregate_edges(*(mine(x) for x in world), mesh=mesh,
                                    dataflow=flow, op=op, wire=wire)
        out["/".join((flow, op, wire))] = sum(c.bytes.values())
    return out


def test_full_graph_bytes_equal_the_reference_hlo_count(reference_programs):
    """8 ranks at ``distributed_cases.py``'s full shape: every rank's bytes
    equal the HLO count the installed JAX gives (it rules where it differs
    from ``BENCH_collective_bytes.json``, written with JAX 0.4.37; at this
    shape the two agree: cgtrans 16384, baseline 300288) and the formula
    ``budgets.edges_bytes``."""
    g = uniform_graph(256, 4096, seed=1, n_features=16, weights=True)
    pg = partition_by_src(g, 8)
    world = (pg.features, pg.src, pg.dst, pg.weights, pg.mask)
    res = meshlib.spawn(_bytes_rank, 8, backend="gloo", device="cpu",
                        timeout_s=TIMEOUT_S, args=(world,))
    with open(os.path.join(ROOT, "BENCH_collective_bytes.json")) as fh:
        bench = {(r["ways"], flow): r[flow] for r in json.load(fh)["rows"]
                 if r.get("mode") == "full" for flow in FLOWS}
    for key in res[0]:
        flow, op, wire = key.split("/")
        live = reference_programs["bytes/" + key]
        want = budgets.edges_bytes(flow, wire, 8, pg.part_size, 16,
                                   reference_programs["e_max"])
        assert live == want, (key, live, want)
        for out in res:
            assert out[key] == live, (key, out[key], live)
        if wire == "f32":
            assert bench[(8, flow)] == live
    ratio = res[0]["baseline/add/f32"] / res[0]["cgtrans/add/f32"]
    assert ratio > 16                       # fan-in 16: ~18x
