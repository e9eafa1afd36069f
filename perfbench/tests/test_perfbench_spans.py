"""The per-layer metrics read from the program's spans and counters: the
shared reader against a planted summary, and whole runs on the CPU at a
tiny size (host times only, so every device-ms metric is left out)."""

import json
import sys

import pytest

import run
from _tiny import TINY, tiny_checkout
from harness import readers, spans
from repro_torch.runtime import trace

SPAN_METRICS = {"schedule_ms.infer", "find_ms.infer", "liveness_ms.infer",
                "pad_ms.infer", "schedule_ms.train", "gather_bwd_ms.train"}
NEW = SPAN_METRICS | {"wrapper_traffic.infer"}
ROOT = "gcn.forward"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, cell, traced):
    trace.reset()
    return run.run_cell(root, cell, 2**31 + 7, 0.1, traced, "cpu",
                        setup_clock=lambda: 1.0)


def _ctx(units=4, unit="forward", traced=True):
    return readers.Context(unit, units, 1.0, 1.0, {"banded_bytes": 1000},
                           object() if traced else None)


def _planted(monkeypatch, spans_, counters):
    monkeypatch.setattr(trace, "summary",
                        lambda: {"spans": spans_, "counters": counters})


def _rec(calls, device_ms):
    return {"calls": calls, "host_ms": 1.0, "device_ms": device_ms,
            "device_self_ms": device_ms}


def test_the_reader_divides_by_the_window_calls(monkeypatch):
    _planted(monkeypatch, {"gcn.forward": _rec(4, 80.0),
                           "gas.find": _rec(8, 20.0),
                           "gas.pad": _rec(4, None)},
             {"gas.pad.bytes": 4000, "gas.liveness.bytes": 0})
    ctx = _ctx()
    assert spans.span_ms(ctx, "forward", "gas.find", ROOT) == 5.0
    assert spans.counter(ctx, "forward", "gas.pad.bytes", ROOT) == 1000.0
    assert spans.counter(ctx, "forward", "gas.liveness.bytes", ROOT) == 0.0


@pytest.mark.parametrize("root,read", [("gcn.forward", None),
                                       ("serve.drain", 5.0)])
def test_the_reader_counts_calls_by_the_root_it_is_given(monkeypatch, root,
                                                         read):
    # another entry's root, once per call: the GCN root ran 3 times
    _planted(monkeypatch, {"gcn.forward": _rec(3, 80.0),
                           "serve.drain": _rec(4, 80.0),
                           "gas.find": _rec(8, 20.0)}, {})
    assert spans.span_ms(_ctx(), "forward", "gas.find", root) == read


@pytest.mark.parametrize("ctx,unit,recs,read", [
    (_ctx(traced=False), "forward", {}, ("span", "gas.find")),
    (_ctx(), "step", {}, ("span", "gas.find")),
    (_ctx(), "forward", {}, ("span", "gas.pad")),          # no device time
    (_ctx(), "forward", {}, ("span", "gas.kernel")),       # not recorded
    (_ctx(), "forward", {}, ("counter", "gas.liveness.bytes")),
    (_ctx(), "forward", {"gcn.forward": _rec(3, 80.0)},    # not the window
     ("counter", "gas.pad.bytes")),
    (_ctx(), "forward", {"gcn.forward": None}, ("span", "gas.find"))],
    ids=["untraced", "other unit", "no device time", "no such span",
         "no such counter", "root calls differ", "no root"])
def test_the_reader_makes_up_nothing(monkeypatch, ctx, unit, recs, read):
    planted = {"gcn.forward": _rec(4, 80.0), "gas.find": _rec(8, 20.0),
               "gas.pad": _rec(4, None)}
    planted.update(recs)
    _planted(monkeypatch, {k: v for k, v in planted.items() if v},
             {"gas.pad.bytes": 4000})
    kind, name = read
    reader = spans.span_ms if kind == "span" else spans.counter
    assert reader(ctx, unit, name, ROOT) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    # a program from before the recorder has no such module
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch.runtime"], "trace")
    assert spans.span_ms(_ctx(), "forward", "gas.find", ROOT) is None
    assert spans.counter(_ctx(), "forward", "gas.pad.bytes", ROOT) is None


def _wrapper_bytes(E, widths):
    """Pad and liveness bytes of one forward: each layer's (E, f) f32
    values padded to a multiple of 32 features (a read of E·f, a write of
    E·fp; none where f is a multiple of 32), and the liveness pass's read
    of the padded E·fp."""
    total = 0
    for f in widths:
        fp = -(-f // 32) * 32
        total += (4 * (E * f + E * fp) if fp != f else 0) + 4 * E * fp
    return total


@pytest.mark.parametrize("cell,config", [
    ("sage-reddit.full-infer", "sage-reddit"),
    ("sage-ogbn100m.full-infer", "sage-ogbn100m")])
def test_a_traced_run_reports_the_wrapper_traffic_by_hand(root, cell,
                                                          config):
    t = TINY[config]
    V, E = 1 << t["scale"], t["edge_factor"] << t["scale"]
    assert E % 128 == 0          # no edge pad in the hand count
    out = _run(root, cell, True)
    assert out["correct"], out["checks"]
    widths = [t["F"], t["H"]]
    aggregation = sum(2 * V * f * 4 + 12 * E for f in widths)
    got = out["metrics"]["wrapper_traffic.infer"]
    assert got["unit"] == "x"
    assert got["value"] == pytest.approx(_wrapper_bytes(E, widths)
                                         / aggregation, rel=1e-12)
    # a CPU run takes no device time: no device-ms metric is made up
    assert not SPAN_METRICS & set(out["metrics"])
    s = trace.summary()
    assert s["spans"]["gcn.forward"]["calls"] == out["attempted"]
    assert s["spans"]["gas.find"]["device_ms"] is None
    json.dumps(out)


def test_the_train_cell_records_its_backward(root):
    out = _run(root, "sage-reddit.full-train", True)
    assert out["correct"], out["checks"]
    assert not NEW & set(out["metrics"])
    s = trace.summary()["spans"]
    n = out["attempted"]
    assert s["gcn.forward"]["calls"] == s["adamw.update"]["calls"] == n
    assert s["gas.gather_backward"]["calls"] == n
    assert s["cgtrans.schedule"]["calls"] == n


@pytest.mark.parametrize("cell", ["sage-reddit.full-infer",
                                  "sage-reddit.full-train"])
def test_an_untraced_run_records_no_span(root, cell):
    out = _run(root, cell, False)
    assert out["correct"], out["checks"]
    assert not NEW & set(out["metrics"])
    assert trace.summary() == {"spans": {}, "counters": {}}
