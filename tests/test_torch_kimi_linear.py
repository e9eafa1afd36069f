"""Kimi-Linear-48B-A3B in the port against the plain float32 reference
``tests/reference/kimi_linear.py``, on the CPU: the chunked Kimi Delta
Attention (KDA) scan, the whole mixer, rotary-free latent attention, and
a reduced model that keeps every mechanism (a dense first KDA layer, the
3 : 1 hybrid period looped, the irregular (KDA, MLA) tail unrolled, MoE
layers with the biased sigmoid router and a share of 2 of 16 experts),
each layer checkpointed as the full model runs (``remat="layer"``).

Both sides compute in float32. The scans are also held to the token by
token recurrence in float64, within 1e-5 of its largest value forward
and in every input's gradient, at decays strong enough that e^{−G} of
the cumulative log-decay overflows float32 within one chunk. The
whole-model tolerances are Moonlight's (``test_torch_moonlight.py``):
the loss to 2e-6 relative, each gradient leaf to 2e-5 of its largest
element (measured: up to 9.3e-6); the two sides sum in other orders.
The train step holds each step's loss to the reference's on the
program's own parameters (a routing choice between two experts whose
scores lie 5e-5 apart flips under float32 drift, and after it the
trajectories part) and the first update to the reference's AdamW within
2e-4 of its leaf's largest (measured: up to 1.2e-4): AdamW's first step
maps a gradient element g to g / (|g| + eps), so where |g| lies near eps
(1e-3 here) the gradient's rounding grows by up to max|g| / (4 eps).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.common.config import TrainConfig
from repro_torch.common.schema import count_params, init_params
from repro_torch.configs import kimi_linear_48b_a3b as kimi
from repro_torch.models import kda, mla, moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import LayerCtx, rope_tables
from repro_torch.train import init_state, make_train_step

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "kimi_linear_reference", Path(__file__).parent / "reference" /
    "kimi_linear.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

ROOT = Path(__file__).resolve().parents[1]
KDA_LAYERS = [1, 2, 3, 5, 6, 7, 9, 10]
FULL_LAYERS = [4, 8, 11]
SMALL = dataclasses.replace(
    kimi.CONFIG, n_layers=11, d_model=64, n_heads=4, head_dim=16,
    qk_rope_dim=8, v_head_dim=16, kv_lora_rank=32, d_ff=32, d_ff_dense=96,
    n_experts=16, top_k=4, vocab=256, router_aux_coef=0.1,
    layers=kimi.layer_kinds(KDA_LAYERS, FULL_LAYERS, 1),
    kda_heads=2, kda_head_dim=16, kda_gate_rank=8,
    compute_dtype="float32", held_experts=16)
CUT = kimi.share(SMALL, ep=8, rank=1, vocab=SMALL.vocab)
B, S = 2, 150         # two whole chunks of the scan and a part


def ref_cfg(cfg):
    """The reference's plain dict of ``cfg``."""
    kinds = cfg.layer_kinds()
    return {"num_attention_heads": cfg.n_heads,
            "qk_nope_head_dim": cfg.head_dim,
            "qk_rope_head_dim": cfg.qk_rope_dim,
            "v_head_dim": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank,
            "rms_norm_eps": cfg.norm_eps,
            "num_experts_per_tok": cfg.top_k,
            "routed_scaling_factor": cfg.routed_scale,
            "router_width": cfg.n_experts,
            "n_routed_experts": cfg.held_experts,
            "held_first": cfg.held_first,
            "first_k_dense_replace": cfg.first_k_dense,
            "num_hidden_layers": cfg.n_layers,
            "linear_attn_config": {
                "num_heads": cfg.kda_heads, "head_dim": cfg.kda_head_dim,
                "kda_layers": [i + 1 for i, k in enumerate(kinds)
                               if k.startswith("kda")]},
            "aux_alpha": cfg.router_aux_coef}


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * max(scale, 1e-30), \
        (float((got - want).abs().max()), scale)


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# the published config
# ---------------------------------------------------------------------------

def _catalog():
    """The published config.json's numbers, as the benchmark's file holds
    them."""
    return json.loads((ROOT / "perfbench" / "configs" / "lm" /
                       "kimi-linear-48b-a3b.json").read_text())


def test_the_layer_kinds_are_the_published_lists():
    conf = _catalog()["linear_attn_config"]
    cfg = configs.get_config("kimi-linear-48b-a3b")
    assert cfg is kimi.CONFIG and cfg.name not in configs.ARCHS
    kinds = cfg.layer_kinds()
    assert [i + 1 for i, k in enumerate(kinds) if k.startswith("kda")] == \
        conf["kda_layers"]
    assert [i + 1 for i, k in enumerate(kinds) if k in ("moe", "attn")] == \
        conf["full_attn_layers"] == [4, 8, 12, 16, 20, 24, 27]
    assert kinds[0] == "kda_dense" and set(kinds[1:]) == {"kda", "moe"}
    with pytest.raises(ValueError, match="once each"):
        kimi.layer_kinds([1, 2, 4], [3, 4], 1)


def test_the_stack_loops_the_hybrid_period_and_unrolls_the_tail():
    lay = T.stack_layout(kimi.CONFIG)
    assert lay == T.StackLayout(("kda_dense",), ("kda", "kda", "moe", "kda"),
                                6, ("kda", "moe"))
    assert T.stack_layout(CUT) == T.StackLayout(
        ("kda_dense",), ("kda", "kda", "moe", "kda"), 2, ("kda", "moe"))
    assert T._period(("a", "b", "a", "b", "a")) == ("a", "b")
    assert T._period(("a", "b", "c")) == ("a", "b", "c")
    assert T._period(("a",) * 5) == ("a",)
    # a repeated config keeps its pattern's layout
    moon = configs.get_config("moonlight-16b-a3b")
    assert T.stack_layout(moon) == T.StackLayout(("attn",), ("moe",), 26, ())


def test_the_published_config_and_its_one_chip_share():
    cut = kimi.share(ep=32, vocab=20480)
    assert (cut.held_first, cut.held_experts, cut.n_experts, cut.top_k) == \
        (0, 8, 256, 8)
    schema = T.model_schema(cut)
    st = schema["stack"]
    # by hand: KDA's w_qkv 2304·3·4096, the conv 4·12288, the decay gate
    # 2304·128 + 128·4096 + 4096 + 32, β 2304·32, the output gate
    # 2304·128 + 128·4096, its norm 128, W_o 4096·2304
    kda_ = (2304 * 12288 + 4 * 12288 + 2 * (2304 * 128 + 128 * 4096)
            + 4096 + 32 + 2304 * 32 + 128 + 4096 * 2304)
    mla_ = 2304 * 6144 + 2304 * 576 + 512 + 512 * 8192 + 4096 * 2304
    moe_ = 2304 * 256 + 256 + 8 * 3 * 2304 * 1024 + 3 * 2304 * 1024
    assert (kda_, mla_, moe_) == (39_514_272, 29_114_880, 64_291_072)
    assert count_params(st["prefix_0"]["mixer"]) == kda_
    assert count_params(st["suffix_1"]["attn"]) == mla_
    assert count_params(st["suffix_0"]["moe"]) == moe_
    assert count_params(st["prefix_0"]["mlp"]) == 3 * 2304 * 9216
    total = count_params(schema)
    assert total == (20 * kda_ + 7 * mla_ + 26 * moe_ + 3 * 2304 * 9216
                     + 2 * 27 * 2304 + 2 * 20480 * 2304 + 2304)
    assert total == 2_823_857_024      # 45.2 GB at 16 bytes a parameter


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _recurrence(q, k, v, g, beta):
    """Token by token in float64: q, k, v, g (B, S, H, d), beta (B, S, H)
    → o (B, S, H, d)."""
    q, k, v, g, beta = (t.double() for t in (q, k, v, g, beta))
    state = q.new_zeros(q.shape[0], q.shape[2], q.shape[3], v.shape[3])
    out = []
    for t in range(q.shape[1]):
        state = state * torch.exp(g[:, t])[..., None]
        u = beta[:, t, :, None] * (
            v[:, t] - torch.einsum("bhk,bhkv->bhv", k[:, t], state))
        state = state + torch.einsum("bhk,bhv->bhkv", k[:, t], u)
        out.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(out, dim=1)


def _ref_scan(q, k, v, g, beta):
    heads = lambda t: t.transpose(1, 2)  # noqa: E731
    return heads(ref.kda_scan(heads(q), heads(k), heads(v), heads(g),
                              heads(beta)))


def _inputs(seed, S_, strength, beta_at):
    gen = torch.Generator().manual_seed(seed)
    H, d = 3, 8
    unit = lambda: torch.nn.functional.normalize(  # noqa: E731
        torch.randn(2, S_, H, d, generator=gen), dim=-1)
    q, k = unit() * d ** -0.5, unit()
    v = torch.randn(2, S_, H, d, generator=gen)
    g = -strength * torch.rand(2, S_, H, d, generator=gen)
    if beta_at is None:
        beta = torch.rand(2, S_, H, generator=gen)
    else:
        beta = torch.full((2, S_, H), beta_at)
    return [t.requires_grad_(True) for t in (q, k, v, g, beta)]


@pytest.mark.parametrize("S_,strength,beta_at", [
    (45, 30.0, None),       # a chunk's log-decay reaches −960 and more
    (100, 3.0, None),
    (64, 0.02, None),       # long memory: the state carries across chunks
    (37, 1.0, 1e-4),        # β near 0: hardly any write
    (37, 1.0, 1 - 1e-4),    # β near 1: the delta rule's full correction
], ids=str)
def test_both_chunked_scans_equal_the_recurrence(S_, strength, beta_at):
    inputs = _inputs(S_, S_, strength, beta_at)
    want = _recurrence(*inputs)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    want_g = torch.autograd.grad((want * w).sum(), inputs)
    if strength >= 30:
        # e^{−G} of a chunk's cumulative log-decay overflows float32
        G = torch.cumsum(inputs[3].detach()[:, :16], dim=1)
        assert bool(torch.isinf(torch.exp(-G)).any())
    for name, fn in (("program, chunk 16", lambda *a: kda.chunk_scan(
            *a, 16)), ("program, chunk 64", lambda *a: kda.chunk_scan(*a, 64)),
                     ("reference", _ref_scan)):
        got = fn(*inputs)
        assert got.dtype == torch.float32, name
        _close(got.double(), want, 1e-5)
        grads = torch.autograd.grad((got.double() * w).sum(), inputs)
        for gi, wi in zip(grads, want_g):
            assert bool(torch.isfinite(gi).all()), name
            _close(gi.double(), wi, 1e-5)


def test_the_carry_holds_the_state_between_chunks():
    """A key written in the first chunk is read back from a later one
    through the carried state alone."""
    q, k, v, g, beta = (t.detach() for t in _inputs(1, 48, 0.0, 1.0))
    k[:, 1:] = 0.0
    out = kda.chunk_scan(q, k, v, g, beta, 16)
    # no decay, β = 1, one key: S = k_0 v_0ᵀ for every later token
    want = torch.einsum("bhk,bshk->bsh", k[:, 0], q)[..., None] * v[:, :1]
    _close(out[:, 20:], want[:, 20:], 1e-6)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _kda_params(cfg, seed=3):
    p = init_params(kda.kda_schema(cfg), seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    p["o_norm"]["w"] = 1 + 0.1 * torch.randn(cfg.kda_head_dim, generator=gen)
    return p


def test_the_kda_mixer_matches_the_reference():
    p = _kda_params(SMALL)
    x = torch.randn(B, S, SMALL.d_model,
                    generator=torch.Generator().manual_seed(4))
    got = kda.kda_apply(p, x, SMALL)
    want = ref.kda(p, x, ref_cfg(SMALL))
    _close(got, want, 2e-6)
    # causal: a later token changes no earlier output
    x2 = x.clone()
    x2[:, -1] += 1.0
    assert torch.equal(kda.kda_apply(p, x2, SMALL)[:, :-1], got[:, :-1])
    # the decay is per channel: one decay per head moves the output
    mean = kda.decay(p, x, SMALL).mean(-1, keepdim=True)
    old = kda.decay
    kda.decay = lambda *a: mean.expand(-1, -1, -1, SMALL.kda_head_dim)
    try:
        per_head = kda.kda_apply(p, x, SMALL)
    finally:
        kda.decay = old
    assert float((per_head - got).abs().max()) > 1e-3 * float(
        got.abs().max())


def _ctx(cfg, S_):
    tables = rope_tables(torch.arange(S_), cfg.rope_dim, cfg.rope_theta)
    return LayerCtx(cfg=cfg, rope_local=tables, rope_global=tables,
                    q_chunk=8)


def test_rotary_free_mla_matches_the_reference():
    p = init_params(mla.mla_schema(SMALL), 5, device="cpu")
    p["kv_norm"]["w"] = 1 + 0.1 * torch.randn(SMALL.kv_lora_rank)
    x = torch.randn(B, S, SMALL.d_model,
                    generator=torch.Generator().manual_seed(6))
    got = mla.mla_apply(p, x, _ctx(SMALL, S))
    _close(got, ref.mla(p, x, ref_cfg(SMALL)), 2e-6)
    roped = mla.mla_apply(p, x, _ctx(dataclasses.replace(
        SMALL, mla_nope=False), S))
    assert torch.equal(roped[:, 0], got[:, 0])    # position 0 turns by 0
    assert not torch.allclose(roped, got, atol=1e-4)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _params(cfg, seed=0, bias_std=0.05):
    p = init_params(T.model_schema(cfg), seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in ref.flat(p).items():
        if k.endswith("moe.bias"):
            v.copy_(bias_std * torch.randn(v.shape, generator=gen))
        if k.endswith("o_norm.w"):
            v.copy_(1 + 0.1 * torch.randn(v.shape, generator=gen))
    return p


def _batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed + 2)
    ids = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def test_loss_and_every_gradient_match_the_reference():
    params = _params(CUT)
    batch = _batch(CUT)
    trainable = lambda k: not k.endswith("moe.bias")  # noqa: E731
    live = {k: v.clone().requires_grad_(trainable(k))
            for k, v in ref.flat(params).items()}
    total, metrics = T.loss_fn(_unflat(live), batch, CUT)
    keys = sorted(k for k in live if trainable(k))
    got = torch.autograd.grad(total, [live[k] for k in keys])
    rlive = {k: v.clone().requires_grad_(trainable(k))
             for k, v in ref.flat(params).items()}
    rtotal, rxent, raux = ref.loss(_unflat(rlive), batch["tokens"],
                                   batch["labels"], ref_cfg(CUT))
    want = torch.autograd.grad(rtotal, [rlive[k] for k in keys])
    assert float(metrics["aux_loss"]) > 0.5
    assert float(total) == pytest.approx(float(rtotal), rel=2e-6)
    assert float(metrics["loss"]) == pytest.approx(float(rxent), rel=2e-6)
    assert float(metrics["aux_loss"]) == pytest.approx(float(raux), rel=2e-6)
    assert any(".mixer." in k for k in keys) and any(
        "suffix_1.attn" in k for k in keys)
    for k, g, w in zip(keys, got, want):
        assert float(w.abs().max()) > 0, k
        _close(g, w, 2e-5)


def test_the_train_step_matches_the_reference_and_keeps_the_bias():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=5,
                     eps=1e-3)
    params = _params(CUT)
    state = init_state(CUT, tc, device="cpu")
    flat = ref.flat(state["params"])
    for k, v in ref.flat(params).items():
        flat[k].copy_(v)
    step = make_train_step(CUT, tc)
    opt = None
    for i in range(2):
        start = {k: v.clone() for k, v in ref.flat(state["params"]).items()}
        trainable = {k: v.clone() for k, v in start.items()
                     if not k.endswith("moe.bias")}
        batch = _batch(CUT, seed=i)
        state, metrics = step(state, batch)
        live = {k: v.clone().requires_grad_(k in trainable)
                for k, v in start.items()}
        rtotal, _, _ = ref.loss(_unflat(live), batch["tokens"],
                                batch["labels"], ref_cfg(CUT))
        assert float(metrics["total_loss"]) == pytest.approx(
            float(rtotal), rel=2e-6)
        if opt is None:
            keys = sorted(trainable)
            grads = torch.autograd.grad(rtotal, [live[k] for k in keys])
            opt = ref.AdamW(trainable, dataclasses.asdict(tc))
            opt.step(trainable, dict(zip(keys, grads)))
            got = ref.flat(state["params"])
            for k, v in start.items():
                if k.endswith("moe.bias"):
                    assert torch.equal(got[k], v)
                else:
                    assert not torch.equal(got[k], v), k
                    _close(got[k] - v, trainable[k] - v, 2e-4)


def test_the_shares_sum_to_the_uncut_layer():
    """Eight chips' shares of one Kimi MoE layer (top-4 of 16 here, one
    shared expert counted once) add up to the reference layer that holds
    all 16 experts."""
    p = init_params(moe.moe_schema(SMALL), 6, device="cpu")
    p["bias"].copy_(0.05 * torch.randn(16, generator=torch.Generator()
                                       .manual_seed(6)))
    x = torch.randn(B, S, SMALL.d_model)
    full, _ = ref.moe(p, x, ref_cfg(SMALL))
    shared = ref.swiglu(p["shared"], x.reshape(-1, SMALL.d_model)
                        ).reshape(B, S, -1)
    total = shared.clone()
    for r in range(8):
        cut = kimi.share(SMALL, ep=8, rank=r, vocab=SMALL.vocab)
        pr = dict(p)
        for k in ("w_gate", "w_up", "w_down"):
            pr[k] = p[k][2 * r:2 * r + 2]
        out, _ = moe.moe_apply(pr, x, cut)
        total = total + (out - shared)
    _close(total, full, 5e-6)


@pytest.mark.parametrize("cfg,names", [
    (CUT, ("MLA", "KDA")),
    (dataclasses.replace(CUT, kv_lora_rank=0,
                         layers=("kda_dense",) + ("kda",) * 10), ("KDA",)),
], ids=["kimi", "kda-only"])
def test_prefill_and_decode_name_each_missing_cache(cfg, names):
    params = init_params(T.model_schema(cfg), 0, device="cpu")
    for call in (lambda: T.prefill(
            params, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, cfg,
            cache_len=8),
                 lambda: T.decode_step(params, torch.zeros(
                     1, 1, dtype=torch.long), {}, 0, cfg)):
        with pytest.raises(NotImplementedError) as err:
            call()
        msg = str(err.value)
        assert all(n in msg for n in names), msg
        assert ("MLA" in msg) == ("MLA" in names), msg
