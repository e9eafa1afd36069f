"""The LM training cell (``moonlight-16b-a3b.moe-train``): its operation
count by hand, its configuration file read into the port's config at the
published widths, the benchmark's own draw of the starting parameters,
whole runs on the CPU at a tiny size (sound, and each planted control not
correct), and its per-layer metric readers against a planted summary."""

import json

import pytest
import torch

import run
from _tiny import ROOT, scaled_checkout
from _tiny_lm import CELL, TINY, tiny_lm_checkout
from harness import faults, lm_counts, lm_inputs, readers, spec
from repro_torch.common.schema import count_params, leaves
from repro_torch.models import transformer as T
from repro_torch.runtime import trace

SPAN_METRICS = ("mla_ms.moe-train", "moe_ms.moe-train",
                "experts_ms.moe-train")


def _conf(**kw):
    c = dict(hidden_size=2048, num_hidden_layers=27,
             first_k_dense_replace=1, router_width=64,
             num_experts_per_tok=6, n_routed_experts=8,
             moe_intermediate_size=1408, intermediate_size=11264,
             n_shared_experts=2, vocab_size=20480, num_attention_heads=16,
             qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
             kv_lora_rank=512)
    c.update(kw)
    return c


def test_lm_flops_by_hand_at_a_small_shape():
    # D 4, 2 layers (1 dense, 1 MoE), 1 head: n 2, r 2, v 2, L 2; dense
    # MLP 6, experts 3 wide, 4 routed of which 2 held, top-2, 1 shared,
    # vocab 5; B 1, S 3 → T 3 tokens, 6 causal pairs
    c = _conf(hidden_size=4, num_hidden_layers=2, router_width=4,
              num_experts_per_tok=2, n_routed_experts=2,
              moe_intermediate_size=3, intermediate_size=6,
              n_shared_experts=1, vocab_size=5, num_attention_heads=1,
              qk_nope_head_dim=2, qk_rope_head_dim=2, v_head_dim=2,
              kv_lora_rank=2)
    attn = 4 * 4 + 4 * 4 + 2 * 4 + 2 * 4      # wq, wkva, wkvb, wo
    per_token = 2 * attn + 3 * 4 * 6 + (3 * 4 * 3 + 4 * 4) + 4 * 5
    slots = 3 * 2 * 2 / 4                      # T · k · held / E
    expert = 3 * 4 * 3
    pairs = 1 * 1 * 3 * 4 // 2
    fwd = 2 * 3 * per_token + 2 * slots * expert + 2 * 2 * pairs * (4 + 2)
    assert lm_counts.forward_flops(c, 1, 3) == int(fwd)
    assert lm_counts.train_flops(c, 1, 3) == 3 * int(fwd)


def test_lm_flops_at_the_cell():
    c = _conf()
    attn = 2 * 27 * 2 * 16 * (8192 * 8193 // 2) * (192 + 128)
    fwd = lm_counts.forward_flops(c, 2, 8192)
    assert attn == pytest.approx(18.56e12, rel=1e-3)
    assert (fwd - attn) / 16384 == pytest.approx(2.209e9, rel=1e-3)
    assert lm_counts.train_flops(c, 2, 8192) == pytest.approx(164.26e12,
                                                              rel=1e-4)


def test_the_configuration_file_is_run_at_its_published_widths():
    c = spec.cell(ROOT, CELL)
    entry = spec.entry_module(c)
    cfg = entry.program_config(c.config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank) == \
        (27, 2048, 16, 128, 64, 128, 512)
    assert (cfg.n_experts, cfg.held_experts, cfg.held_first, cfg.top_k,
            cfg.d_ff, cfg.d_ff_dense, cfg.vocab) == \
        (64, 8, 0, 6, 1408, 11264, 20480)
    assert (cfg.routed_scale, cfg.router_aux_coef, cfg.compute_dtype,
            cfg.param_dtype, cfg.remat) == \
        (2.446, 1e-4, "bfloat16", "float32", "block")
    assert count_params(T.model_schema(cfg)) == 2_777_412_736
    assert c.config["published"] == {"n_routed_experts": 64,
                                     "vocab_size": 163840}
    bad = dict(c.config, scoring_func="softmax")
    with pytest.raises(ValueError, match="scoring_func"):
        entry.program_config(bad)


def test_the_benchmark_draws_the_weights_in_the_programs_layout():
    c = spec.cell(ROOT, CELL)
    entry = spec.entry_module(c)
    shapes = lm_inputs.shapes(entry.reference_config(c.config))
    program = {".".join(p): tuple(d.shape)
               for p, d in leaves(T.model_schema(entry.program_config(
                   c.config)))}
    assert {k: s for k, (s, _) in shapes.items()} == program
    assert sum(torch.Size(s).numel() for s, _ in shapes.values()) == \
        2_777_412_736
    # the head contracts over the hidden width, the experts' down
    # projection over their own width
    assert shapes["unembed.table"] == ((20480, 2048), 2048)
    assert shapes["stack.blocks.p0.moe.w_down"] == ((26, 8, 1408, 2048),
                                                    1408)


def test_a_leaf_drawn_again_alone_is_the_one_drawn_with_all(root):
    c = spec.cell(root, CELL)
    conf = spec.entry_module(c).reference_config(c.config)
    whole = lm_inputs.params(conf, 2**40 + 7, "cpu")
    names = ["stack.blocks.p0.moe.w_gate", "unembed.table",
             "stack.blocks.p0.moe.bias"]
    again = lm_inputs.params(conf, 2**40 + 7, "cpu", names)
    assert set(again) == set(names)
    for k in names:
        assert torch.equal(again[k], whole[k])
    other = lm_inputs.params(conf, 2**40 + 8, "cpu", names)
    assert not torch.equal(other["unembed.table"], whole["unembed.table"])
    # the selection bias comes from the file's own seed, not the run's
    assert torch.equal(other["stack.blocks.p0.moe.bias"],
                       whole["stack.blocks.p0.moe.bias"])
    assert whole["stack.blocks.p0.moe.bias"].std() > 0
    assert torch.equal(whole["final_norm.w"], torch.ones(TINY["hidden_size"]))


def test_a_program_tree_that_differs_from_the_layout_is_refused(root):
    c = spec.cell(root, CELL)
    runner = spec.entry_module(c).Runner(c, 3, "cpu")
    flat = runner._inputs()
    flat.pop("stack.prefix_0.attn.wo")
    with pytest.raises(ValueError, match="attn.wo"):
        runner._program_params(flat)


def test_the_graph_scaled_checkout_leaves_the_lm_configuration_alone(
        tmp_path):
    root = scaled_checkout(tmp_path, 10)
    conf = spec.cell(root, CELL).config
    assert conf == spec.cell(ROOT, CELL).config
    assert spec.cell(root, "sage-reddit.full-train").config["vertices"] == \
        1 << 10


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_lm_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, trace_on=False):
    trace.reset()
    return run.run_cell(root, CELL, 2**31 + 13, 0.2, trace_on, "cpu",
                        setup_clock=lambda: 1.0)


def test_a_sound_tiny_run_is_correct_and_traced(root):
    out = _run(root, True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "route_gap"}
    assert 0 < out["metrics"]["mfu.moe-train"]["value"] < 100
    # a CPU run takes no device time: no span metric is made up
    assert not set(SPAN_METRICS) & set(out["metrics"])
    s = trace.summary()
    n = out["attempted"]
    assert s["spans"]["lm.loss"]["calls"] == s["spans"]["adamw.update"][
        "calls"] == n
    # 3 layers' attention and 2 MoE layers', each block's again in the
    # backward's recomputation
    assert s["spans"]["mla.attention"]["calls"] == 5 * n
    assert s["spans"]["moe.experts"]["calls"] == 4 * n
    slots = 2 * 32 * TINY["num_experts_per_tok"]
    assert s["counters"]["moe.dispatch.bytes"] == \
        4 * n * slots * TINY["hidden_size"] * 4
    json.dumps(out)


def test_an_untraced_tiny_run_reports_the_step(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"full_step_ms", "setup_s"}
    assert trace.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("fault", ["capacity", "biased", "fp8"])
def test_each_planted_control_is_not_correct(root, fault):
    entry = spec.entry_module(spec.cell(root, CELL))
    assert set(entry.FAULTS) == {"capacity", "biased", "fp8"}
    with faults.plant(entry, fault):
        out = _run(root)
    assert not out["correct"], (fault, out["checks"])


def _ctx(units=4, traced=True):
    return readers.Context("step", units, 2.0, 1.0, {"flops": 989e12},
                           object() if traced else None)


def _planted(monkeypatch, names):
    rec = lambda calls, ms: {"calls": calls, "host_ms": 1.0,  # noqa: E731
                             "device_ms": ms, "device_self_ms": ms}
    spans = {"lm.loss": rec(4, 900.0), "mla.attention": rec(20, 80.0),
             "moe.route": rec(8, 4.0), "moe.experts": rec(8, 12.0),
             "moe.combine": rec(8, 8.0)}
    monkeypatch.setattr(trace, "summary", lambda: {
        "spans": {k: v for k, v in spans.items() if k in names},
        "counters": {}})


def test_the_span_metrics_read_device_ms_per_step(monkeypatch):
    _planted(monkeypatch, {"lm.loss", "mla.attention", "moe.route",
                           "moe.experts", "moe.combine"})
    read = {m: spec.metric_reader(ROOT, m).read(_ctx())
            for m in SPAN_METRICS}
    assert read == {"mla_ms.moe-train": 20.0, "moe_ms.moe-train": 6.0,
                    "experts_ms.moe-train": 3.0}


def test_moe_ms_reads_nothing_where_a_span_is_missing(monkeypatch):
    _planted(monkeypatch, {"lm.loss", "moe.route", "moe.experts"})
    assert spec.metric_reader(ROOT, "moe_ms.moe-train").read(_ctx()) is None
    assert spec.metric_reader(ROOT, "experts_ms.moe-train").read(
        _ctx()) == 3.0


def test_idle_and_launches_read_the_cells_trace():
    class Trace:
        window_s = 2.0

        def busy_s(self):
            return 1.5

        def launches(self):
            return 40
    ctx = readers.Context("step", 4, 2.0, 1.0, {"flops": 1.0}, Trace())
    idle = spec.metric_reader(ROOT, "device_idle.moe-train")
    launches = spec.metric_reader(ROOT, "launches.moe-train")
    assert idle.read(ctx) == pytest.approx(25.0)
    assert launches.read(ctx) == 10.0
    assert idle.read(_ctx(traced=False)) is None
    assert launches.read(_ctx(traced=False)) is None
    names = {m["name"] for m in spec.cell(ROOT, CELL).per_layer}
    assert {"device_idle.moe-train", "launches.moe-train"} <= names


def test_mfu_is_the_step_flops_over_the_bf16_peak():
    class Window:
        window_s = 2.0
    ctx = readers.Context("step", 4, 2.0, 1.0, {"flops": 989e12}, Window())
    mfu = spec.metric_reader(ROOT, "mfu.moe-train")
    assert mfu.read(ctx) == pytest.approx(200.0)
    assert mfu.read(readers.Context("step", 4, 2.0, 1.0, {"flops": 1.0},
                                    None)) is None
    assert mfu.read(readers.Context("forward", 4, 2.0, 1.0,
                                    {"flops": 1.0}, Window())) is None
