"""The port's span and counter recorder (``repro_torch.runtime.trace``).

Off, a span is one shared no-op and a whole forward and backward records
nothing. On (``trace.recording()``), at a tiny size on ``impl="kernel"``
(the kernels' plain versions on the CPU): the spans nest under their
parents with their root's call id through the forward and the gather
backward, the wrapper's byte counters and the fused route's count equal
hand counts from the shapes and are the only counters, the fused route
engages where its input shows the case, recording leaves
``count_dispatches``' static view as it was, and no device time is made
up. The self-time
arithmetic, the kept calls and the thread-local parents run on a recorder
whose events are stand-ins with set times.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.core import cgtrans, gcn, sparse
from repro_torch.graph import partition_by_src
from repro_torch.graph.structure import COOGraph
from repro_torch.kernels.gas_scatter import ops as gas_ops
from repro_torch.optim import adamw
from repro_torch.runtime import trace

torch.set_num_threads(1)

V, E, C = 64, 512, 5          # E a multiple of the 128-edge tile


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def _world(F, H, seed=0):
    rng = np.random.default_rng(seed)
    g = COOGraph(V, rng.integers(0, V, E).astype(np.int32),
                 rng.integers(0, V, E).astype(np.int32),
                 rng.random(E).astype(np.float32) + 0.05)
    pg = partition_by_src(g, 1)
    edges = tuple(torch.from_numpy(np.asarray(a))
                  for a in (pg.src, pg.dst, pg.weights, pg.mask))
    assert edges[0].shape == (1, E)
    gen = torch.Generator().manual_seed(seed)
    params = {"w0": torch.randn(2 * F, H, generator=gen) / F,
              "b0": torch.zeros(H), "w1": torch.randn(2 * H, H,
                                                      generator=gen) / H,
              "b1": torch.zeros(H), "w_out": torch.randn(H, C, generator=gen),
              "b_out": torch.zeros(C)}
    feats = torch.randn(1, V, F, generator=gen)
    cfg = gcn.GCNConfig(n_features=F, hidden=H, n_classes=C, impl="kernel")
    return params, feats, edges, cfg


def _step(params, feats, edges, cfg):
    """A forward, its backward and one AdamW update."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    gcn.gcn_forward_full(p, feats, *edges, cfg).square().sum().backward()
    tc = TrainConfig()
    adamw.adamw_update(p, {k: v.grad for k, v in p.items()},
                       adamw.adamw_init(p, tc), tc)


def test_off_a_span_is_the_shared_no_op_and_nothing_records():
    s = trace.span("a", torch.zeros(1))
    assert s is trace.span("b") and s.__enter__() is None
    trace.add("c", 5)
    _step(*_world(40, 16))
    assert trace.summary() == {"spans": {}, "counters": {}}
    assert trace.calls() == [] and trace.current_call() is None


# the forward's spans by (name, parent), in the order they close; then
# layer 1's gather backward, in the backward's own call of the same id
FORWARD = [("cgtrans.schedule", "gcn.forward")] + [
    ("gas.find", "cgtrans.aggregate"), ("gas.pad", "gas.scatter"),
    ("gas.kernel", "gas.scatter"),
    ("gas.scatter", "cgtrans.aggregate"),
    ("cgtrans.aggregate", "gcn.forward")] * 2 + [("gcn.forward", None)]
BACKWARD = [("gas.pad", "gas.scatter"), ("gas.kernel", "gas.scatter"),
            ("gas.scatter", "gas.gather_backward"),
            ("gas.gather_backward", None)]


def test_spans_nest_under_their_parents_with_their_root_call_id():
    world = _world(40, 16)
    with trace.recording():
        assert trace.span("a") is not trace.span("b")
        _step(*world)
        _step(*world)
    assert trace.span("a") is trace.span("b")
    calls = trace.calls()
    # two steps: each a forward call (its backward under the same id) and
    # an AdamW call
    assert [[(r["name"], r["parent"]) for r in c["spans"]] for c in calls] \
        == [FORWARD + BACKWARD, [("adamw.update", None)]] * 2
    ids = [c["call"] for c in calls]
    assert len(set(ids)) == 4 and ids == sorted(ids)
    for c in calls:
        for r in c["spans"]:
            assert r["host_ms"] >= 0 and r["device_ms"] is None
            assert r["device_self_ms"] is None
    s = trace.summary()["spans"]
    assert s["gcn.forward"]["calls"] == 2 and s["gas.kernel"]["calls"] == 6
    assert s["gcn.forward"]["host_ms"] >= s["cgtrans.aggregate"]["host_ms"]
    assert all(r["device_ms"] is None and r["device_self_ms"] is None
               for r in s.values())


def _bytes(n, widths):
    """Pad bytes: each (n, f) f32 array padded to 32 features, a read of
    n·f plus a write of n·fp, none at a multiple of 32."""
    pad = 0
    for f in widths:
        fp = -(-f // 32) * 32
        pad += 4 * n * (f + fp) if fp != f else 0
    return pad


@pytest.mark.parametrize("F,H", [(40, 16), (32, 32), (602, 64)])
def test_wrapper_byte_counters_equal_hand_counts(F, H):
    world = _world(F, H)
    with trace.recording():
        _step(*world)
    got = trace.summary()["counters"]
    # each layer's banded walk reads its rows from the (V, f) table, which
    # the wrapper pads once: no (E, f) stream is gathered or padded; the
    # gather backward pads the (E, H) cotangent
    pad = _bytes(V, [F, H]) + _bytes(E, [H])
    assert got["gas.pad.bytes"] == pad
    # both layers took the fused route
    assert got["gas.find.fused"] == 2
    # the banded kernel decides feature-block liveness from the rows it
    # stages: no pass outside it reads a value byte for it
    assert got["gas.liveness.bytes"] == 0
    if F % 32 == 0 and H % 32 == 0:
        assert got["gas.pad.bytes"] == 0
    # the gather backward's dense grid sorts its E tile-padded edges by
    # row: 28 bytes an edge and 12 a row-block bound
    E_pad, n_blocks = -(-E // 128) * 128, -(-V // 128)
    assert got["gas.dense.index.bytes"] == 28 * E_pad + 12 * (n_blocks + 1)
    assert set(got) == {"gas.pad.bytes", "gas.liveness.bytes",
                        "gas.dense.index.bytes", "gas.find.fused"}


def _fused_count(fn):
    """``gas.find.fused`` over one run of ``fn``."""
    trace.reset()
    with trace.recording(), torch.no_grad():
        fn()
    return trace.summary()["counters"].get("gas.find.fused", 0)


def test_the_fused_route_engages_where_its_input_shows_the_case():
    """``gas.find.fused`` counts the aggregations whose kernel reads each
    edge's row from the table: both layers of a forward of the
    Reddit-shaped world (F 602), and none where the input does not show a
    scheduled add of a dense float32 table on the kernel: max, no
    schedule, ``impl="ref"``, a bf16 table, the packed (sparse) find, the
    sampled path. ``gcn_forward_full`` reads the table packed at layer 0
    only, so its layer 1 still fuses."""
    params, feats, edges, cfg = _world(602, 64)

    def fwd(x=feats, **kw):
        return lambda: gcn.gcn_forward_full(params, x, *edges,
                                            dataclasses.replace(cfg, **kw))
    assert _fused_count(fwd()) == 2
    assert _fused_count(fwd(aggregate="max")) == 0
    assert _fused_count(fwd(scheduled=False)) == 0
    assert _fused_count(fwd(impl="ref")) == 0
    stream = cgtrans.edge_stream(*edges, feats.shape[:2], impl="kernel")
    assert _fused_count(lambda: cgtrans.aggregate_stream(
        feats.to(torch.bfloat16), stream, impl="kernel")) == 0
    relu = torch.relu(feats - 1.5)
    cap = sparse.table_capacity(relu)
    assert sparse.sparse_fits(cap, 602)
    assert _fused_count(lambda: cgtrans.aggregate_stream(
        relu, stream, impl="kernel", features="sparse",
        sparse_capacity=cap)) == 0
    assert _fused_count(fwd(relu, features="sparse",
                            sparse_capacity=cap)) == 1
    nbrs = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (1, 8, 4)).astype(np.int32))
    assert _fused_count(lambda: cgtrans.aggregate_sampled(
        feats, nbrs, torch.ones(nbrs.shape, dtype=torch.bool),
        impl="kernel")) == 0


def test_an_edge_pad_counts_both_copies():
    vals = torch.ones(130, 40)
    with trace.recording():
        out = gas_ops._padded_values(vals)
        gas_ops._padded_values(torch.ones(256, 64))
        gas_ops._padded_values(torch.ones(64, 256).t())
    assert out.shape == (256, 64)
    # rows 130 → 256 (read 130·40, write 256·40), then features 40 → 64
    # (read 256·40, write 256·64); the transposed stream's contiguous copy
    assert trace.summary()["counters"]["gas.pad.bytes"] == 4 * (
        130 * 40 + 256 * 40 + 256 * 40 + 256 * 64) + 2 * 4 * 256 * 64


def test_recording_leaves_the_static_dispatch_counts_as_they_were():
    params, feats, edges, cfg = _world(40, 16)

    def counted():
        with gas_ops.count_dispatches() as static, torch.no_grad():
            gcn.gcn_forward_full(params, feats, *edges, cfg)
            with gas_ops.suspend_counting():
                gcn.gcn_forward_full(params, feats, *edges, cfg)
        return dict(static)

    off = counted()
    with trace.recording():
        on = counted()
    # each forward counted: a find, a reduce and a kernel scatter per layer
    assert off == on == {"find": 2, "reduce": 2, "kernel_scatter": 2}
    assert trace.summary()["spans"]["gcn.forward"]["calls"] == 2


class _Event:
    """A stand-in for a CUDA timing event, stamped by a shared clock."""
    clock = [0.0]

    def record(self, stream=None):
        self.t = self.clock[0]

    def elapsed_time(self, end):
        return end.t - self.t

    def query(self):
        return True

    def synchronize(self):
        pass


class _OnCard:
    is_cuda = True
    device = torch.device("cuda", 0)


def _stand_in_recorder(monkeypatch):
    rec = trace.Recorder()

    def event(device):
        ev = _Event()
        ev.record()
        return ev
    monkeypatch.setattr(rec, "_event", event)
    return rec


def test_device_self_time_is_less_the_child_spans(monkeypatch):
    rec = _stand_in_recorder(monkeypatch)
    clock, on = _Event.clock, _OnCard()
    clock[0] = 0.0
    with rec.recording():
        with rec.span("root", on):
            clock[0] = 1.0
            with rec.span("child", on):
                clock[0] = 4.0
                with rec.span("grandchild", on):
                    clock[0] = 6.0
            with rec.span("host", None):
                clock[0] = 7.0
            with rec.span("child", on):
                clock[0] = 9.0
            clock[0] = 10.0
    # root [0, 10]; child [1, 6] over grandchild [4, 6]; the host span
    # [6, 7] takes no device time; child [7, 9]
    s = rec.summary()["spans"]
    assert (s["root"]["device_ms"], s["root"]["device_self_ms"]) == (10, 3)
    assert (s["child"]["calls"], s["child"]["device_ms"],
            s["child"]["device_self_ms"]) == (2, 7, 5)
    assert s["grandchild"]["device_self_ms"] == 2
    assert s["host"]["device_ms"] is None


def test_only_the_last_calls_are_kept(monkeypatch):
    monkeypatch.setattr(trace, "KEEP_CALLS", 3)
    rec = _stand_in_recorder(monkeypatch)
    with rec.recording():
        for _ in range(5):
            with rec.span("root", _OnCard()):
                pass
    assert [c["call"] for c in rec.calls()] == [3, 4, 5]
    assert rec.summary()["spans"]["root"]["calls"] == 5


def test_parents_are_per_thread_and_a_backward_keeps_its_call():
    rec = trace.Recorder()
    seen = {}

    def backward(call):
        with rec.span("bwd", call=call):
            with rec.span("inner"):
                seen["inner"] = rec.current_call()

    with rec.recording():
        with rec.span("fwd"):
            call = rec.current_call()
            t = threading.Thread(target=backward, args=(call,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert seen["inner"] == call
    recs = {r["name"]: r for c in rec.calls() for r in c["spans"]}
    assert recs["bwd"]["parent"] is None and recs["inner"]["parent"] == "bwd"
    assert [c["call"] for c in rec.calls()] == [call]


def test_a_profiler_session_turns_recording_on():
    from torch.profiler import ProfilerActivity, profile
    world = _world(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("a") is not trace.span("b")
        with torch.no_grad():
            gcn.gcn_forward_full(world[0], world[1], *world[2], world[3])
    assert trace.span("a") is trace.span("b")
    assert trace.summary()["spans"]["gcn.forward"]["calls"] == 1
    names = {e.name for e in prof.events()}
    assert {"gcn.forward", "gas.pad", "gas.kernel"} <= names
    assert "gas.liveness" not in names


def test_an_lm_step_records_the_moe_and_latent_attention_spans():
    """One training step of a reduced Moonlight (1 dense + 2 checkpointed
    MoE layers): ``lm.loss`` once, the root of the forward's spans; each
    layer's ``mla.attention`` and each MoE layer's three spans in the
    forward and again in the blocks' recomputation; the dispatch counter
    from the shapes, every slot's row once per routed pass."""
    import dataclasses

    from repro_torch.configs import moonlight_16b_a3b as moonlight
    from repro_torch.train import init_state, make_train_step

    cfg = moonlight.share(dataclasses.replace(
        moonlight.CONFIG, n_layers=3, d_model=64, n_heads=4, head_dim=16,
        qk_rope_dim=8, v_head_dim=16, kv_lora_rank=32, d_ff=32,
        d_ff_dense=96, n_experts=16, top_k=4, vocab=256,
        compute_dtype="float32"), ep=8, vocab=256)
    tc = TrainConfig()
    state = init_state(cfg, tc, device="cpu")
    tokens = torch.randint(0, 256, (2, 16))
    with trace.recording():
        make_train_step(cfg, tc)(state, {"tokens": tokens,
                                         "labels": tokens})
    s = trace.summary()
    calls = {k: v["calls"] for k, v in s["spans"].items()}
    assert calls == {"lm.loss": 1, "mla.attention": 3 + 2,
                     "moe.route": 2 + 2, "moe.experts": 2 + 2,
                     "moe.combine": 2 + 2, "adamw.update": 1}
    assert s["counters"] == {"moe.dispatch.bytes": 4 * (2 * 16 * 4 * 64 * 4)}
    forward = trace.calls()[0]["spans"]
    assert forward[-1] == {**forward[-1], "name": "lm.loss", "parent": None}
    assert {r["parent"] for r in forward[:-1]} == {"lm.loss"}


def test_an_lm_step_records_the_kda_spans():
    """One training step of a reduced Kimi Linear (a dense KDA layer, the
    (KDA, KDA, MLA, KDA) period twice, the (KDA, MLA) tail), every layer
    its own checkpoint: each KDA layer's ``kda.mixer`` and its scan's
    ``kda.chunk`` in the forward and again in its recomputation, beside
    the MLA and MoE spans."""
    import dataclasses

    from repro_torch.configs import kimi_linear_48b_a3b as kimi
    from repro_torch.train import init_state, make_train_step

    cfg = kimi.share(dataclasses.replace(
        kimi.CONFIG, n_layers=11, d_model=64, n_heads=4, head_dim=16,
        qk_rope_dim=8, v_head_dim=16, kv_lora_rank=32, d_ff=32,
        d_ff_dense=96, n_experts=16, top_k=4, vocab=256,
        layers=kimi.layer_kinds([1, 2, 3, 5, 6, 7, 9, 10], [4, 8, 11], 1),
        kda_heads=2, kda_head_dim=16, kda_gate_rank=8,
        compute_dtype="float32"), ep=8, vocab=256)
    tc = TrainConfig()
    state = init_state(cfg, tc, device="cpu")
    tokens = torch.randint(0, 256, (2, 24))
    with trace.recording():
        make_train_step(cfg, tc)(state, {"tokens": tokens,
                                         "labels": tokens})
    s = trace.summary()
    calls = {k: v["calls"] for k, v in s["spans"].items()}
    assert calls == {"lm.loss": 1, "kda.mixer": 8 * 2, "kda.chunk": 8 * 2,
                     "mla.attention": 3 * 2, "moe.route": 10 * 2,
                     "moe.experts": 10 * 2, "moe.combine": 10 * 2,
                     "adamw.update": 1}
    forward = trace.calls()[0]["spans"]
    parents = {r["name"]: r["parent"] for r in forward}
    assert parents["kda.chunk"] == "kda.mixer"
    assert parents["kda.mixer"] == "lm.loss"
