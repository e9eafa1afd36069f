"""The hybrid LM training cell (``kimi-linear-48b-a3b.kda-train``): its
operation count by hand, its configuration file read into the port's
config at the published widths, the benchmark's own draw of the starting
parameters in the program's layout, whole runs on the CPU at a tiny size
(sound, and each planted control not correct), and its per-layer metric
readers against a planted summary."""

import json

import pytest
import torch

import run
from _tiny import ROOT
from _tiny_kda import CELL, TINY, tiny_kda_checkout
from harness import faults, kda_counts, kda_inputs, lm_counts, readers, spec
from repro_torch.common.schema import count_params, leaves
from repro_torch.models import transformer as T
from repro_torch.runtime import trace

SPAN_METRICS = ("kda_ms.kda-train", "kda_scan_ms.kda-train")
KDA_LAYERS = [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26]


def _conf(**kw):
    c = dict(hidden_size=2304, num_hidden_layers=27,
             first_k_dense_replace=1, router_width=256,
             num_experts_per_token=8, n_routed_experts=8,
             moe_intermediate_size=1024, intermediate_size=9216,
             num_shared_experts=1, vocab_size=20480, num_attention_heads=32,
             qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
             kv_lora_rank=512, kda_gate_rank=128,
             linear_attn_config={"num_heads": 32, "head_dim": 128,
                                 "kda_layers": KDA_LAYERS})
    c.update(kw)
    return c


def test_kda_flops_by_hand_at_a_small_shape():
    # D 4; 3 layers: KDA + dense (width 6), MLA + MoE, KDA + MoE; KDA 1
    # head of 2, gate rank 1; MLA 1 head, n 2, r 2, v 2, L 2; experts 3
    # wide, 4 routed of which 2 held, top-2, 1 shared; vocab 5; B 1, S 3
    c = _conf(hidden_size=4, num_hidden_layers=3, router_width=4,
              num_experts_per_token=2, n_routed_experts=2,
              moe_intermediate_size=3, intermediate_size=6,
              num_shared_experts=1, vocab_size=5, num_attention_heads=1,
              qk_nope_head_dim=2, qk_rope_head_dim=2, v_head_dim=2,
              kv_lora_rank=2, kda_gate_rank=1,
              linear_attn_config={"num_heads": 1, "head_dim": 2,
                                  "kda_layers": [1, 3]})
    kda = 4 * 6 + 2 * (4 * 1 + 1 * 2) + 4 * 1 + 2 * 4   # qkv, gates, β, W_o
    mla = 4 * 4 + 4 * 4 + 2 * 4 + 2 * 4
    per_token = (2 * kda + mla + 3 * 4 * 6 + 2 * (3 * 4 * 3 + 4 * 4)
                 + 4 * 5)
    slots = 3 * 2 * 2 / 4
    pairs = 1 * 1 * 3 * 4 // 2
    scan = 3 * 1 * 3 * 2 * 2 * 2               # T · H · 3 products · 2d²
    fwd = (2 * 3 * per_token + 2 * slots * 3 * 4 * 3 * 2
           + 2 * pairs * (4 + 2) + 2 * scan)
    assert kda_counts.forward_flops(c, 1, 3) == int(fwd)
    assert kda_counts.train_flops(c, 1, 3) == 3 * int(fwd)


def test_kda_flops_at_the_cell():
    c = _conf()
    T_ = 2 * 8192
    kda = 20 * 2 * T_ * kda_counts.kda_weights(c) + 20 * T_ * 32 * 6 * 128**2
    mla = 7 * (2 * T_ * lm_counts.mla_weights(c)
               + 2 * 2 * 32 * (8192 * 8193 // 2) * 320)
    assert kda == pytest.approx(26.87e12, rel=1e-3)
    assert mla == pytest.approx(16.30e12, rel=1e-3)
    fwd = kda_counts.forward_flops(c, 2, 8192)
    assert fwd == pytest.approx(54.8e12, rel=2e-3)
    assert kda_counts.train_flops(c, 2, 8192) == 3 * fwd


def test_the_configuration_file_is_run_at_its_published_widths():
    c = spec.cell(ROOT, CELL)
    entry = spec.entry_module(c)
    cfg = entry.program_config(c.config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank,
            cfg.mla_nope) == (27, 2304, 32, 128, 64, 128, 512, True)
    assert (cfg.kda_heads, cfg.kda_head_dim, cfg.kda_gate_rank,
            cfg.conv_kernel) == (32, 128, 128, 4)
    assert (cfg.n_experts, cfg.held_experts, cfg.held_first, cfg.top_k,
            cfg.d_ff, cfg.d_ff_dense, cfg.n_shared_experts, cfg.vocab) == \
        (256, 8, 0, 8, 1024, 9216, 1, 20480)
    assert (cfg.routed_scale, cfg.router_aux_coef, cfg.compute_dtype,
            cfg.param_dtype, cfg.remat) == \
        (2.446, 1e-4, "bfloat16", "float32", "layer")
    kinds = cfg.layer_kinds()
    assert [i + 1 for i, k in enumerate(kinds) if k.startswith("kda")] == \
        c.config["linear_attn_config"]["kda_layers"] == KDA_LAYERS
    assert count_params(T.model_schema(cfg)) == 2_823_857_024
    assert c.config["published"] == {"num_experts": 256,
                                     "vocab_size": 163840}
    bad = dict(c.config, mla_use_nope=False)
    with pytest.raises(ValueError, match="mla_use_nope"):
        entry.program_config(bad)


def test_the_benchmark_draws_the_weights_in_the_programs_layout():
    c = spec.cell(ROOT, CELL)
    entry = spec.entry_module(c)
    rcfg = entry.reference_config(c.config)
    shapes = kda_inputs.shapes(rcfg)
    program = {".".join(p): tuple(d.shape)
               for p, d in leaves(T.model_schema(entry.program_config(
                   c.config)))}
    assert {k: s for k, (s, _) in shapes.items()} == program
    assert sum(torch.Size(s).numel() for s, _ in shapes.values()) == \
        2_823_857_024
    pre, run_, reps, post = kda_inputs.layout(rcfg)
    assert (len(pre), len(run_), reps, len(post)) == (1, 4, 6, 2)
    assert shapes["stack.blocks.p0.mixer.w_qkv"] == ((6, 2304, 3, 4096),
                                                     2304)
    assert shapes["stack.suffix_1.attn.wq"] == ((2304, 6144), 2304)
    assert shapes["stack.prefix_0.mixer.conv_w"] == ((4, 12288), 4)


def test_a_leaf_drawn_again_alone_is_the_one_drawn_with_all(root):
    c = spec.cell(root, CELL)
    conf = spec.entry_module(c).reference_config(c.config)
    whole = kda_inputs.params(conf, 2**40 + 7, "cpu")
    names = ["stack.blocks.p0.mixer.a_log", "stack.blocks.p0.mixer.dt_bias",
             "unembed.table", "stack.suffix_0.moe.bias"]
    again = kda_inputs.params(conf, 2**40 + 7, "cpu", names)
    assert set(again) == set(names)
    for k in names:
        assert torch.equal(again[k], whole[k])
    other = kda_inputs.params(conf, 2**40 + 8, "cpu", names)
    assert not torch.equal(other["unembed.table"], whole["unembed.table"])
    assert torch.equal(other["stack.suffix_0.moe.bias"],
                       whole["stack.suffix_0.moe.bias"])
    A = torch.exp(whole["stack.blocks.p0.mixer.a_log"])
    assert bool(((A >= 1) & (A <= 16)).all())
    dt = torch.nn.functional.softplus(whole["stack.blocks.p0.mixer.dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_kda_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, trace_on=False):
    trace.reset()
    return run.run_cell(root, CELL, 2**31 + 13, 0.2, trace_on, "cpu",
                        setup_clock=lambda: 1.0)


def test_a_sound_tiny_run_is_correct_and_traced(root):
    out = _run(root, True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "route_gap", "kda_gap", "scan_gap",
                                  "expert_gap"}
    assert 0 < out["metrics"]["mfu.kda-train"]["value"] < 100
    # a CPU run takes no device time: no span metric is made up
    assert not set(SPAN_METRICS) & set(out["metrics"])
    s = trace.summary()
    n = out["attempted"]
    assert s["spans"]["lm.loss"]["calls"] == n
    # 8 KDA layers, 3 MLA, 10 MoE, each layer again in its recomputation
    assert s["spans"]["kda.mixer"]["calls"] == \
        s["spans"]["kda.chunk"]["calls"] == 16 * n
    assert s["spans"]["mla.attention"]["calls"] == 6 * n
    assert s["spans"]["moe.experts"]["calls"] == 20 * n
    json.dumps(out)


def test_an_untraced_tiny_run_reports_the_step(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"full_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["capacity", "biased", "fp8",
                                   "bf16_state", "head_decay"])
def test_each_planted_control_is_not_correct(root, fault):
    entry = spec.entry_module(spec.cell(root, CELL))
    assert set(entry.FAULTS) == {"capacity", "biased", "fp8", "bf16_state",
                                 "head_decay"}
    with faults.plant(entry, fault):
        out = _run(root)
    assert not out["correct"], (fault, out["checks"])
    # each control fails the number that isolates it
    gap = {"capacity": "route_gap", "biased": "route_gap",
           "fp8": "expert_gap", "bf16_state": "scan_gap",
           "head_decay": "kda_gap"}[fault]
    assert out["checks"][gap]["value"] > out["checks"][gap]["limit"]


def _ctx(units=4, traced=True):
    return readers.Context("step", units, 2.0, 1.0, {"flops": 989e12},
                           object() if traced else None)


def test_the_span_metrics_read_device_ms_per_step(monkeypatch):
    rec = lambda calls, ms: {"calls": calls, "host_ms": 1.0,  # noqa: E731
                             "device_ms": ms, "device_self_ms": ms}
    spans = {"lm.loss": rec(4, 900.0), "kda.mixer": rec(160, 400.0),
             "kda.chunk": rec(160, 120.0)}
    monkeypatch.setattr(trace, "summary",
                        lambda: {"spans": spans, "counters": {}})
    read = {m: spec.metric_reader(ROOT, m).read(_ctx())
            for m in SPAN_METRICS}
    assert read == {"kda_ms.kda-train": 100.0, "kda_scan_ms.kda-train": 30.0}
    del spans["kda.chunk"]
    assert spec.metric_reader(ROOT, "kda_scan_ms.kda-train").read(
        _ctx()) is None
    assert spec.metric_reader(ROOT, "kda_ms.kda-train").read(
        _ctx(traced=False)) is None


def test_idle_launches_and_mfu_read_the_cells_trace():
    class Trace:
        window_s = 2.0

        def busy_s(self):
            return 1.5

        def launches(self):
            return 40
    ctx = readers.Context("step", 4, 2.0, 1.0, {"flops": 989e12}, Trace())
    read = lambda m, c: spec.metric_reader(ROOT, m).read(c)  # noqa: E731
    assert read("device_idle.kda-train", ctx) == pytest.approx(25.0)
    assert read("launches.kda-train", ctx) == 10.0
    assert read("mfu.kda-train", ctx) == pytest.approx(200.0)
    for m in ("device_idle.kda-train", "launches.kda-train",
              "mfu.kda-train"):
        assert read(m, _ctx(traced=False)) is None
    names = {m["name"] for m in spec.cell(ROOT, CELL).per_layer}
    assert names == {"mfu.kda-train", "kda_ms.kda-train",
                     "kda_scan_ms.kda-train", "device_idle.kda-train",
                     "launches.kda-train"}
    assert [m["name"] for m in spec.cell(ROOT, CELL).end_to_end] == \
        ["full_step_ms", "setup_s"]
