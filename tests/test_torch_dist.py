"""Port parity: the sharded dataflows on ``torch.distributed``.

gloo ranks on the CPU (``repro_torch.launch.mesh.spawn``) against the JAX
package computed in this process on its 1-device topology (``mesh=None``),
with numpy arrays passing between them. JAX's own tiers hold its sharded
dataflows equal to its unsharded ones bit for bit on integer data, so each
rank's slice must equal the reference's slice bit for bit:

* ``aggregate_multi`` / ``aggregate_sampled`` for P in {2, 4}, both
  dataflows, add / max / min / or, chunked and unchunked, ``impl`` ref and
  kernel, and the feature table's gradient (add; every count a power of
  two, so the backward's sums are exact in any order);
* the collective and dispatch counts against ``analysis/budgets.py``,
  forward and forward + backward; the pallas tables' psums are checked
  against the reference's own grad program (``test_pallas_psums_*``);
* the bytes of both dataflows at ``tests/distributed_cases.py``'s
  ``cgtrans_collective_bytes`` shape, equal to the reference's HLO count;
* three sharded ``make_sage_train_step`` steps against JAX's unsharded
  step (loss 1e-4, params 1e-5, as ``tests/test_torch_train.py``);
* the serving engine on 2 ranks against the unsharded engine, with
  collectives per drain independent of the number of requests;
* ``launch.train --shards 8 --backend gloo``, the NCCL refusal without
  cards, and ``spawn``'s failure and deadline handling.

The ranks import ``torch`` and ``repro_torch`` only: this module imports
JAX inside the functions that compute the reference, and each rank reports
the modules it holds.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis import budgets
from repro_torch.core import cgtrans, collectives, gas
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
CHUNKS = (None, 4)
JIMPL = {"ref": "xla", "kernel": "pallas"}
PART, F = 16, 8
SEGMENTS = ((6, 1), (6, 4))       # the sage pair: K=1 lookup + fan-out
B, K1, K2, HIDDEN, CLASSES = 4, 3, 3, 16, 4


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the reference, in this process
# ---------------------------------------------------------------------------

def _agg_world(P):
    rng = np.random.default_rng(P)
    feats = rng.integers(-8, 9, (P, PART, F)).astype(np.float32)
    blocks = []
    for R, K in SEGMENTS:
        nbrs = rng.integers(0, P * PART, (P, R, K)).astype(np.int32)
        # a power-of-two count of valid samples per row (0, 1, 2 or K=4)
        valid = rng.choice([0, 1, 2, K], (P, R)) if K > 1 else \
            (rng.random((P, R)) < 0.8).astype(int)
        order = rng.random((P, R, K)).argsort(-1)
        mask = order < valid[..., None]
        blocks.append((nbrs, mask))
    cots = [rng.integers(-3, 4, (P, R, F)).astype(np.float32)
            for R, _ in SEGMENTS]
    return {"feats": feats, "blocks": blocks, "cots": cots}


def _train_world(P):
    from repro.data import GraphBatchStream, synthetic_node_labels
    from repro.graph import partition_by_src, uniform_graph

    g = uniform_graph(16 * P, 128 * P, seed=P, n_features=F)
    pg = partition_by_src(g, P)
    stream = GraphBatchStream(g, synthetic_node_labels(g.features, CLASSES),
                              n_parts=P, batch_per_part=B, k1=K1, k2=K2)
    return pg.features, [stream.batch_at(i) for i in range(3)]


def _train_kw():
    return dict(learning_rate=1e-2, warmup_steps=0, total_steps=3,
                weight_decay=0.0)


def _jax_train(P, impl):
    """JAX's unsharded step over the global batch: (initial state, losses,
    params after each step)."""
    import jax
    import jax.numpy as jnp

    from repro.common.config import TrainConfig
    from repro.common.schema import init_params
    from repro.core.gcn import GCNConfig, gcn_schema
    from repro.optim import adamw_init
    from repro.train import make_sage_train_step

    feats, batches = _train_world(P)
    cfg = GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                    fanout=K2, impl=JIMPL[impl])
    tc = TrainConfig(**_train_kw())
    params = init_params(gcn_schema(cfg), jax.random.PRNGKey(0))
    state = {"params": params, "opt": adamw_init(params, tc),
             "step": jnp.zeros((), jnp.int32)}
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(make_sage_train_step(cfg, tc, feats=jnp.asarray(feats)))
    losses, after = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["total_loss"]))
        after.append(jax.tree.map(np.asarray, state["params"]))
    return init, losses, after


@pytest.fixture(scope="module")
def reference():
    """JAX on the 1-device topology, per P, computed once."""
    import jax
    import jax.numpy as jnp

    from repro.core import cgtrans as jcg

    cache = {}

    def get(P):
        if P in cache:
            return cache[P]
        w = _agg_world(P)
        feats = jnp.asarray(w["feats"])
        blocks = [(jnp.asarray(n), jnp.asarray(m)) for n, m in w["blocks"]]
        out = {}
        for impl in IMPLS:
            for op in OPS:
                out[("multi", op, impl)] = [np.asarray(o) for o in
                                            jcg.aggregate_multi(
                                                feats, blocks, op=op,
                                                impl=JIMPL[impl])]
                out[("sampled", op, impl)] = np.asarray(jcg.aggregate_sampled(
                    feats, *blocks[1], op=op, impl=JIMPL[impl]))

            def loss(f, impl=impl):
                outs = jcg.aggregate_multi(f, blocks, impl=JIMPL[impl])
                return sum((o * jnp.asarray(u)).sum()
                           for o, u in zip(outs, w["cots"]))
            out[("grad", impl)] = np.asarray(jax.grad(loss)(feats))
        for impl in IMPLS:
            out[("train", impl)] = _jax_train(P, impl)
        cache[P] = out
        return out

    return get


# ---------------------------------------------------------------------------
# the ranks (torch and repro_torch only)
# ---------------------------------------------------------------------------

def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _counted(fn):
    with collectives.count_collectives() as c, gas.count_dispatches() as d:
        out = fn()
    return out, {**c.as_dict(), **{k: v for k, v in d.items() if v}}


def _agg_rank(mesh, world, trains):
    from repro_torch.core.gcn import GCNConfig
    from repro_torch.common.config import TrainConfig
    from repro_torch.train import make_sage_train_step, state_from_jax

    r = mesh.rank
    mine = lambda x: torch.from_numpy(np.ascontiguousarray(x[r:r + 1]))  # noqa
    feats = mine(world["feats"])
    blocks = [(mine(n), mine(m)) for n, m in world["blocks"]]
    cots = [mine(u) for u in world["cots"]]
    out = {}
    for flow in FLOWS:
        for impl in IMPLS:
            for chunk in CHUNKS:
                kw = dict(mesh=mesh, dataflow=flow, impl=impl,
                          request_chunk=chunk)
                for op in OPS:
                    outs, counts = _counted(lambda: cgtrans.aggregate_multi(
                        feats, blocks, op=op, **kw))
                    out[("multi", flow, op, impl, chunk)] = (
                        [o.numpy() for o in outs], counts)
                for op in ("add", "max"):
                    got, counts = _counted(lambda: cgtrans.aggregate_sampled(
                        feats, *blocks[1], op=op, **kw))
                    out[("sampled", flow, op, impl, chunk)] = (got.numpy(),
                                                               counts)
                f = feats.clone().requires_grad_(True)

                def fwd_bwd():
                    outs = cgtrans.aggregate_multi(f, blocks, **kw)
                    sum((o * u).sum() for o, u in zip(outs, cots)).backward()
                _, counts = _counted(fwd_bwd)
                out[("grad", flow, impl, chunk)] = (f.grad.numpy(), counts)

    # three train steps from the reference's initial state
    pfeats, batches = trains["world"]
    for impl in IMPLS:
        cfg = GCNConfig(n_features=F, hidden=HIDDEN, n_classes=CLASSES,
                        fanout=K2, impl=impl)
        step = make_sage_train_step(cfg, TrainConfig(**_train_kw()),
                                    feats=mine(pfeats), mesh=mesh)
        state = state_from_jax(trains[impl], device="cpu")
        losses, after, counts = [], [], []
        for b in batches:
            (state, m), c = _counted(lambda: step(state, mesh.shard(b)))
            losses.append(float(m["total_loss"]))
            after.append(meshlib.host(state["params"]))
            counts.append(c)
        out[("train", impl)] = (losses, after, counts)
    out["modules"] = _foreign_modules()
    return out


def _engine_rank(mesh, feats, indptr, indices):
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.serving import ServingEngine

    out = {}
    for impl, scheduled in (("kernel", True), ("kernel", False),
                            ("ref", None)):
        eng = _engine(ServingEngine, feats, indptr, indices, mesh=mesh,
                      impl=impl, scheduled=scheduled)
        rids, _ = replay_traffic(eng, requests=16, tenants=4, seed=1)
        out[(impl, scheduled)] = _results(eng, rids)
    for n in (1, 8):
        eng = _engine(ServingEngine, feats, indptr, indices, mesh=mesh,
                      impl="kernel", max_batch=8)
        for s in range(n):
            eng.submit([s, s + 1], tenant=s)
        _, counts = _counted(eng.flush)
        out[("drain", n)] = (counts, dict(eng.stats))
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * mesh.rank
    x.requires_grad_(True)
    wts = torch.arange(mesh.size * 6, dtype=torch.float32).reshape(
        mesh.size, 3, 2)
    (gathered, summed, scattered), counts = _counted(lambda: (
        collectives.all_gather(x, mesh),
        collectives.all_reduce(x, mesh),
        collectives.reduce_scatter(wts + mesh.rank, mesh)))
    (gathered * wts).sum().backward()
    out["wrappers"] = (meshlib.host(gathered), meshlib.host(summed),
                       meshlib.host(scattered), x.grad.numpy(), counts)
    out["modules"] = _foreign_modules()
    return out


def _bytes_rank(mesh):
    P_, part, Fb, B_loc, K = mesh.size, 64, 128, 32, 16
    feats = torch.zeros((1, part, Fb))
    nbrs = torch.zeros((1, B_loc, K), dtype=torch.int32)
    mask = torch.ones((1, B_loc, K), dtype=torch.bool)
    out = {}
    for flow in FLOWS:
        with collectives.count_collectives() as c:
            cgtrans.aggregate_sampled(feats, nbrs, mask, mesh=mesh,
                                      dataflow=flow)
        out[flow] = (c.as_dict(), dict(c.bytes))
    return out


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    mesh.barrier()


def _sleeping_rank(mesh):
    time.sleep(120)


def _fake_clock(step=0.001):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def _engine(ServingEngine, feats, indptr, indices, **kw):
    return ServingEngine(feats, indptr, indices, fanout=4, cache_capacity=8,
                         clock=_fake_clock(), sample_seed=0, device="cpu",
                         **{"max_batch": 4, **kw})


def _results(eng, rids):
    return {r: (x.self_rows, x.agg_rows, x.from_cache, x.tenant)
            for r, x in ((r, eng.result(r)) for r in rids)}


@pytest.fixture(scope="module")
def sharded(reference):
    """The ranks' results per P, each P one process group."""
    cache = {}

    def get(P):
        if P not in cache:
            trains = {impl: reference(P)[("train", impl)][0]
                      for impl in IMPLS}
            trains["world"] = _train_world(P)
            cache[P] = meshlib.spawn(_agg_rank, P, backend="gloo",
                                     device="cpu", timeout_s=TIMEOUT_S,
                                     args=(_agg_world(P), trains))
        return cache[P]

    return get


def _serving_world():
    from repro.graph import uniform_graph

    V = 64
    g = uniform_graph(V, 6 * V, seed=4)
    indptr, indices, _ = g.to_csr()
    feats = np.random.default_rng(2).integers(-5, 6, (V, F)).astype(
        np.float32)
    return feats, indptr, indices


@pytest.fixture(scope="module")
def engines():
    """(2 ranks' engine results, the unsharded engine's)."""
    from repro_torch.launch.serve import replay_traffic
    from repro_torch.serving import ServingEngine

    world = _serving_world()
    ranks = meshlib.spawn(_engine_rank, 2, backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S, args=world)
    single = {}
    for impl, scheduled in (("kernel", True), ("kernel", False),
                            ("ref", None)):
        eng = _engine(ServingEngine, *world, impl=impl, scheduled=scheduled)
        rids, _ = replay_traffic(eng, requests=16, tenants=4, seed=1)
        single[(impl, scheduled)] = _results(eng, rids)
    return ranks, single


# ---------------------------------------------------------------------------
# aggregation, values and gradients
# ---------------------------------------------------------------------------

_AGG = [(P, flow, op, impl, chunk) for P in (2, 4) for flow in FLOWS
        for op in OPS for impl in IMPLS for chunk in CHUNKS]


@pytest.mark.parametrize("P,flow,op,impl,chunk", _AGG)
def test_sharded_aggregate_multi_matches_reference(sharded, reference, P,
                                                   flow, op, impl, chunk):
    want = reference(P)[("multi", op, impl)]
    for r, res in enumerate(sharded(P)):
        got, _ = res[("multi", flow, op, impl, chunk)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[r:r + 1])


@pytest.mark.parametrize("P,flow,op,impl,chunk", [
    c for c in _AGG if c[2] in ("add", "max")])
def test_sharded_aggregate_sampled_matches_reference(sharded, reference, P,
                                                     flow, op, impl, chunk):
    want = reference(P)[("sampled", op, impl)]
    budget = budgets.held(budgets.SAMPLED_FWD[flow])
    if chunk is not None:
        budget.update(budgets.chunked_fetch_collectives(1, flow))
    if impl == "kernel":
        budget["kernel_scatter"] = budget["reduce"]
    for r, res in enumerate(sharded(P)):
        got, counts = res[("sampled", flow, op, impl, chunk)]
        np.testing.assert_array_equal(got, want[r:r + 1])
        assert counts == budget


@pytest.mark.parametrize("P,flow,impl,chunk", [
    (P, flow, impl, chunk) for P in (2, 4) for flow in FLOWS
    for impl in IMPLS for chunk in CHUNKS])
def test_sharded_feature_gradient_matches_reference(sharded, reference, P,
                                                    flow, impl, chunk):
    """d/dfeats of the coalesced fetch (add): each rank's rows are its own
    shard of the reference's gradient."""
    want = reference(P)[("grad", impl)]
    for r, res in enumerate(sharded(P)):
        got, _ = res[("grad", flow, impl, chunk)]
        np.testing.assert_array_equal(got, want[r:r + 1])


# ---------------------------------------------------------------------------
# counts against the budgets
# ---------------------------------------------------------------------------

def _fwd_budget(flow, impl, chunk):
    table = budgets.MULTI_FWD[flow]
    want = budgets.held(table)
    if impl == "kernel":
        want["kernel_scatter"] = want["reduce"]
    if chunk is not None:
        # each segment streams as its own command queue: one find site each
        want.update(budgets.chunked_fetch_collectives(len(SEGMENTS), flow),
                    find=len(SEGMENTS))
    return want


@pytest.mark.parametrize("P,flow,impl,chunk", [
    (P, flow, impl, chunk) for P in (2, 4) for flow in FLOWS
    for impl in IMPLS for chunk in CHUNKS])
def test_sharded_forward_counts_equal_the_budgets(sharded, P, flow, impl,
                                                  chunk):
    for res in sharded(P):
        _, counts = res[("multi", flow, "add", impl, chunk)]
        assert counts == _fwd_budget(flow, impl, chunk)


@pytest.mark.parametrize("P,flow,impl", [
    (P, flow, impl) for P in (2, 4) for flow in FLOWS for impl in IMPLS])
def test_sharded_fwd_bwd_counts_equal_the_budgets(sharded, P, flow, impl):
    """Forward + backward in the table, unchunked: the xla table's
    collectives on both routes (the pallas table's psums are not in the
    reference's grad program; see the next test), the pallas table's
    dispatches on the kernel route."""
    want = budgets.held(budgets.MULTI_BWD[flow],
                        budgets.MULTI_BWD_PALLAS[flow]
                        if impl == "kernel" else None)
    for res in sharded(P):
        _, counts = res[("grad", flow, impl, None)]
        assert counts == want


_PROBE = r"""
import json, re
import jax, jax.numpy as jnp, numpy as np
from repro.core import cgtrans
from repro.launch.mesh import make_data_mesh
mesh = make_data_mesh(8)
rng = np.random.default_rng(0)
feats = jnp.asarray(rng.integers(-3, 4, (8, 32, 16)).astype(np.float32))
blocks = [(jnp.asarray(rng.integers(0, 256, (8, 6, k)).astype(np.int32)),
           jnp.asarray(rng.random((8, 6, k)) < 0.8)) for k in (1, 5)]
NAMES = ("all_gather", "all_to_all", "psum", "psum_invariant", "pvary",
         "psum_scatter", "reduce_scatter")
def count(fn, *args):
    txt = str(jax.make_jaxpr(fn)(*args))
    return {n: len(re.findall(r"\b%s\[" % n, txt)) for n in NAMES}
out = {}
for flow in ("cgtrans", "baseline"):
    for impl in ("xla", "pallas"):
        def loss(f, flow=flow, impl=impl):
            return sum(o.sum() for o in cgtrans.aggregate_multi(
                f, blocks, mesh=mesh, dataflow=flow, impl=impl,
                scheduled=False))
        out[f"grad/{flow}/{impl}"] = count(jax.grad(loss), feats)
    out[f"chunked/{flow}"] = count(
        lambda f, flow=flow: cgtrans.aggregate_multi(
            f, blocks, mesh=mesh, dataflow=flow, request_chunk=2), feats)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_programs():
    """Collectives of the reference's own programs on its 8-device mesh
    (a subprocess, as ``tests/_dist.py`` runs them)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("flow", FLOWS)
def test_pallas_psums_are_not_in_the_reference_grad_program(
        reference_programs, flow):
    """``MULTI_BWD_PALLAS`` budgets psums that the reference's own grad
    program does not hold: on its 8-device mesh the pallas route's grad
    jaxpr has no psum of any spelling and the xla route's collectives
    (``all_gather`` 1, ``all_to_all`` 2 or 3). The tables' psums reduce
    no cotangent, so the port's kernel route is held to the xla table
    (``budgets.held``) and issues none."""
    pallas = reference_programs[f"grad/{flow}/pallas"]
    xla = reference_programs[f"grad/{flow}/xla"]
    assert budgets.MULTI_BWD_PALLAS[flow]["psum"] > 0
    for name in ("psum", "psum_invariant", "pvary", "psum_scatter",
                 "reduce_scatter"):
        assert pallas[name] == 0, (name, pallas)
    for name in ("all_gather", "all_to_all"):
        assert pallas[name] == xla[name] == budgets.MULTI_BWD[flow][name]
        assert budgets.held(budgets.MULTI_BWD[flow],
                            budgets.MULTI_BWD_PALLAS[flow])[name] == \
            pallas[name]


@pytest.mark.parametrize("flow", FLOWS)
def test_chunked_budget_is_the_reference_scan(reference_programs, flow):
    got = reference_programs[f"chunked/{flow}"]
    want = budgets.chunked_fetch_collectives(len(SEGMENTS), flow)
    assert {k: got[k] for k in want} == want


# the full-graph rows the reference registers as contracts, not tables
_REGISTERED = {
    "EDGES_FWD_NARROW_ADD": ("aggregate_edges/cgtrans/add/xla/bf16",
                             "aggregate_edges/cgtrans/add/xla/int8"),
    "EDGES_FWD_SPARSE_ADD": ("aggregate_edges/cgtrans/add/xla/sparse",),
}


@pytest.mark.parametrize("name", [
    "SAGE_FETCH_COLLECTIVES", "SAGE_FETCH_DISPATCH",
    "SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD", "SERVE_FETCH_COLLECTIVES",
    "SAMPLED_FWD", "SAMPLED_BWD", "SAMPLED_BWD_PALLAS", "MULTI_FWD",
    "MULTI_BWD", "MULTI_BWD_PALLAS", "SAGE_FWD", "TRAIN", "EDGES_FWD",
    "EDGES_FWD_NARROW_ADD", "EDGES_FWD_SPARSE_ADD"])
def test_budgets_are_the_reference_tables(name):
    from repro.analysis import contracts

    if name in _REGISTERED:
        for key in _REGISTERED[name]:
            assert getattr(budgets, name) == contracts.CONTRACTS[key].forward
        return
    want = getattr(contracts, name if hasattr(contracts, name)
                   else "_" + name)
    assert getattr(budgets, name) == want
    if name == "EDGES_FWD":
        # every registered forward row, kernel scatters included
        for flow in FLOWS:
            for op in ("add", "max"):
                for impl in IMPLS:
                    key = f"aggregate_edges/{flow}/{op}/{JIMPL[impl]}"
                    assert budgets.edges_forward(flow, op, impl) == \
                        contracts.CONTRACTS[key].forward


def test_collective_bytes_beat_a_quarter_of_the_fanout():
    """``distributed_cases.py``'s ``cgtrans_collective_bytes`` shape (8
    ranks, part 64, F 128, 32 seeds x K 16 per rank): the same bytes as the
    reference's HLO count (148480 and 2117632) and a ratio above K/4."""
    res = meshlib.spawn(_bytes_rank, 8, backend="gloo", device="cpu",
                        timeout_s=TIMEOUT_S)
    for out in res:
        (cc, cb), (bc, bb) = out["cgtrans"], out["baseline"]
        assert cc == {"all_gather": 1, "all_to_all": 1}
        assert bc == {"all_gather": 1, "all_to_all": 2}
        assert sum(cb.values()) == 148480
        assert sum(bb.values()) == 2117632
        assert sum(bb.values()) / sum(cb.values()) > 16 / 4


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,impl", [(P, impl) for P in (2, 4)
                                    for impl in IMPLS])
def test_sharded_train_steps_match_reference(sharded, reference, P, impl):
    _, jlosses, jafter = reference(P)[("train", impl)]
    params = None
    for res in sharded(P):
        losses, after, _ = res[("train", impl)]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
        for got, want in zip(after, jafter):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        if params is None:
            params = after
        for a, b in zip(after, params):     # replicated bit for bit
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("P,impl", [(P, impl) for P in (2, 4)
                                    for impl in IMPLS])
def test_train_step_counts_equal_the_budgets(sharded, P, impl):
    """Per step: the reference's ``_TRAIN`` row, exactly one
    ``grad_all_reduce``, and the one ``metric_all_reduce`` of the global
    loss and accuracy."""
    want = budgets.held(budgets.TRAIN[(True, JIMPL[impl])])
    if impl == "kernel":
        want["kernel_scatter"] = budgets.TRAIN[(True, "pallas")][
            "kernel_scatter"]
    want["grad_all_reduce"] = budgets.GRAD_ALL_REDUCE_PER_STEP
    want["metric_all_reduce"] = 1
    for res in sharded(P):
        for counts in res[("train", impl)][2]:
            assert counts == want


@pytest.mark.parametrize("P", [2, 4])
def test_ranks_import_neither_jax_nor_the_reference(sharded, P):
    for res in sharded(P):
        assert res["modules"] == []


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,scheduled", [("kernel", True),
                                            ("kernel", False), ("ref", None)])
def test_sharded_engine_equals_the_unsharded_engine(engines, impl,
                                                    scheduled):
    ranks, single = engines
    want = single[(impl, scheduled)]
    for res in ranks:
        got = res[(impl, scheduled)]
        assert sorted(got) == sorted(want)
        for rid, w in want.items():
            g = got[rid]
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_sharded_drain_collectives_do_not_grow_with_requests(engines):
    ranks, _ = engines
    want = {**budgets.SERVE_FETCH_COLLECTIVES["fused"],
            "result_gather": budgets.RESULT_GATHER_PER_DRAIN}
    for res in ranks:
        (one, s1), (eight, s8) = res[("drain", 1)], res[("drain", 8)]
        assert one == eight == want
        assert s1["command_blocks"] == s8["command_blocks"] == 1
        assert s1["find"] == s8["find"] == 1
        assert (s1["kernel_scatter"], s8["kernel_scatter"]) == (1, 8)
    assert ranks[0]["modules"] == []


def test_collective_wrappers_and_their_transposes(engines):
    ranks, _ = engines
    n = len(ranks)
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
          for r in range(n)]
    wts = np.arange(n * 6, dtype=np.float32).reshape(n, 3, 2)
    for r, res in enumerate(ranks):
        gathered, summed, scattered, grad, counts = res["wrappers"]
        np.testing.assert_array_equal(gathered, np.stack(xs))
        np.testing.assert_array_equal(summed, sum(xs))
        np.testing.assert_array_equal(
            scattered, sum(wts[r] + q for q in range(n)))
        # d/dx of sum(all_gather(x) * wts) on every rank: the reduce-
        # scatter of the ranks' (equal) cotangents
        np.testing.assert_array_equal(grad, n * wts[r])
        assert counts == {"all_gather": 1, "psum": 1, "psum_scatter": 1}


# ---------------------------------------------------------------------------
# the launcher, the backends and the ranks' lifetime
# ---------------------------------------------------------------------------

def test_launch_train_runs_eight_gloo_shards(tmp_path, capfd):
    from repro_torch.launch import train

    rc = train.main(["--shards", "8", "--backend", "gloo", "--device", "cpu",
                     "--steps", "2", "--scale", "8", "--features", "16",
                     "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert rc == 0
    assert "over 8 partition(s)" in out
    assert out.count("done at step 2: eval loss") == 1   # rank 0 prints
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
    # rank 0 wrote the replicated state; every rank resumes from it
    rc = train.main(["--shards", "8", "--backend", "gloo", "--device", "cpu",
                     "--steps", "3", "--scale", "8", "--features", "16",
                     "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert rc == 0
    assert out.count("[resume] restored checkpoint at step 2") == 1
    assert out.count("done at step 3: eval loss") == 1
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]


def test_nccl_without_a_card_per_rank_raises():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present; NCCL has what it needs")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="backend='gloo'"):
        meshlib.spawn(_failing_rank, 2, backend="nccl", device="cuda",
                      timeout_s=30)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        meshlib.make_data_mesh(2, backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        train.main(["--shards", "2", "--device", "cpu", "--steps", "1"])


def test_a_failing_rank_fails_spawn_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 1 failed(.|\n)*rank one fails on purpose"):
        meshlib.spawn(_failing_rank, 2, backend="gloo", device="cpu",
                      timeout_s=60)
    assert time.monotonic() - t0 < 45
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        meshlib.spawn(_sleeping_rank, 2, backend="gloo", device="cpu",
                      timeout_s=5)
    assert time.monotonic() - t0 < 30


def test_a_one_rank_mesh_takes_the_reference_path():
    mesh = meshlib.DataMesh(None, 0, 1, torch.device("cpu"), "gloo")
    assert not cgtrans.is_sharded(mesh) and not cgtrans.is_sharded(None)
    with pytest.raises(NotImplementedError, match="row 2"):
        cgtrans.is_sharded(object())
    w = _agg_world(1)
    blocks = [(torch.from_numpy(n), torch.from_numpy(m))
              for n, m in w["blocks"]]
    feats = torch.from_numpy(w["feats"])
    with collectives.count_collectives() as c:
        a = cgtrans.aggregate_multi(feats, blocks, mesh=mesh)
    b = cgtrans.aggregate_multi(feats, blocks)
    assert c.as_dict() == {}
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
