"""Moonlight-16B-A3B (the DeepSeek-V3 block) in the port against the plain
float32 reference ``tests/reference/moonlight.py``, on the CPU at a
reduced size that keeps every mechanism: latent attention (MLA) in every
layer, a dense first layer, then MoE layers with the biased sigmoid
router, the sequence-wise balance loss, two shared experts and a dropless
share of 2 of the router's 16 experts (one chip of 8), stacked and
checkpointed as the full model runs (``remat="block"``).

Both sides compute in float32 from the same parameters. Tolerances: the
loss to 2e-6 relative and each gradient leaf to 2e-5 of its largest
element — the two sides sum in other orders (the port's grouped GEMM
over sorted slots against the reference's loop over experts, its fused
gate-and-up product, the chunked loss), which moves float32 results by a
few ulps per sum (measured: up to ~2e-6 on gradients); a slot routed to
the wrong expert, a missing term or a weight off by the routed scale moves
them by far more than 1e-3.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.common.config import TrainConfig
from repro_torch.common.schema import count_params, init_params
from repro_torch.configs import moonlight_16b_a3b as moonlight
from repro_torch.models import mla, moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import LayerCtx, rope_tables
from repro_torch.train import init_state, make_train_step

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "moonlight_reference", Path(__file__).parent / "reference" /
    "moonlight.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SMALL = dataclasses.replace(
    moonlight.CONFIG, n_layers=3, d_model=64, n_heads=4, head_dim=16,
    qk_rope_dim=8, v_head_dim=16, kv_lora_rank=32, d_ff=32, d_ff_dense=96,
    n_experts=16, top_k=4, vocab=256, router_aux_coef=0.1,
    compute_dtype="float32", held_experts=16)
CUT = moonlight.share(SMALL, ep=8, rank=1, vocab=SMALL.vocab)
B, S = 2, 32


def ref_cfg(cfg):
    """The reference's plain dict of ``cfg``: the published keys, the
    share and the balance loss's alpha."""
    return {"num_attention_heads": cfg.n_heads,
            "qk_nope_head_dim": cfg.head_dim,
            "qk_rope_head_dim": cfg.qk_rope_dim,
            "v_head_dim": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "num_experts_per_tok": cfg.top_k,
            "routed_scaling_factor": cfg.routed_scale,
            "router_width": cfg.n_experts,
            "n_routed_experts": cfg.held_experts,
            "held_first": cfg.held_first,
            "first_k_dense_replace": cfg.first_k_dense,
            "aux_alpha": cfg.router_aux_coef}


def _params(cfg, seed=0, bias_std=0.05):
    p = init_params(T.model_schema(cfg), seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for path in (("blocks", "p0"), ("prefix_1",), ("prefix_2",)):
        node = p["stack"]
        if path[0] not in node:
            continue
        for k in path:
            node = node[k]
        b = node["moe"]["bias"]
        b.copy_(bias_std * torch.randn(b.shape, generator=gen))
    return p


def _batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed + 2)
    ids = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _leaves(tree, prefix=""):
    return ref.flat(tree, prefix)


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * max(scale, 1e-30), \
        (float((got - want).abs().max()), scale)


def test_the_published_config_and_its_one_chip_share():
    cfg = configs.get_config("moonlight-16b-a3b")
    assert cfg is moonlight.CONFIG and cfg.name not in configs.ARCHS
    assert cfg.layer_kinds() == ("attn",) + ("moe",) * 26
    cut = moonlight.share(ep=8, vocab=20480)
    assert (cut.held_first, cut.held_experts, cut.n_experts) == (0, 8, 64)
    schema = T.model_schema(cut)
    stack = schema["stack"]
    parts = {"embed+head": count_params({k: schema[k] for k in
                                         ("embed", "unembed")}),
             "dense": count_params(stack["prefix_0"]),
             "moe": count_params(stack["blocks"]) // 26,
             "attn": count_params(stack["prefix_0"]["attn"]),
             "shared": count_params(stack["blocks"]["p0"]["moe"]["shared"])
             // 26,
             "expert": 3 * 2048 * 1408}
    # by hand: MLA 2048·3072 + 2048·576 + 512 + 512·4096 + 2048·2048;
    # the dense SwiGLU 3·2048·11264; the shared 3·2048·2816; the router
    # 2048·64 and its 64 biases; two norms of 2048 a layer
    attn = 2048 * 3072 + 2048 * 576 + 512 + 512 * 4096 + 2048 * 2048
    dense = attn + 3 * 2048 * 11264 + 2 * 2048
    layer = attn + 3 * 2048 * 2816 + 2048 * 64 + 64 + 8 * 3 * 2048 * 1408 \
        + 2 * 2048
    assert parts == {"embed+head": 2 * 20480 * 2048, "dense": dense,
                     "moe": layer, "attn": attn, "shared": 3 * 2048 * 2816,
                     "expert": 8_650_752}
    assert (attn, dense, layer) == (13_763_072, 82_973_184, 100_405_824)
    total = count_params(schema)
    assert total == 2 * 20480 * 2048 + dense + 26 * layer + 2048
    assert total == 2_777_412_736      # 44.4 GB at 16 bytes a parameter


def test_loss_and_every_gradient_match_the_reference():
    params = _params(CUT)
    batch = _batch(CUT)
    live = {k: v.clone().requires_grad_(k.split(".")[-1] != "bias")
            for k, v in _leaves(params).items()}
    tree = _unflat(live)
    total, metrics = T.loss_fn(tree, batch, CUT)
    keys = sorted(k for k, v in live.items() if v.requires_grad)
    got = torch.autograd.grad(total, [live[k] for k in keys])

    rlive = {k: v.clone().requires_grad_(k.split(".")[-1] != "bias")
             for k, v in _leaves(params).items()}
    rtotal, rxent, raux = ref.loss(_unflat(rlive), batch["tokens"],
                                   batch["labels"], ref_cfg(CUT))
    want = torch.autograd.grad(rtotal, [rlive[k] for k in keys])
    got_loss = {k: float(v.detach()) for k, v in metrics.items()}
    assert got_loss["aux_loss"] > 0.5            # the balance loss is in
    assert float(total.detach()) == pytest.approx(float(rtotal.detach()),
                                                  rel=2e-6)
    assert got_loss["loss"] == pytest.approx(float(rxent), rel=2e-6)
    assert got_loss["aux_loss"] == pytest.approx(float(raux), rel=2e-6)
    for k, g, w in zip(keys, got, want):
        assert float(w.abs().max()) > 0, k
        _close(g, w, 2e-5)


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _ctx(cfg, S_):
    pos = torch.arange(S_)
    tables = rope_tables(pos, cfg.rope_dim, cfg.rope_theta)
    return LayerCtx(cfg=cfg, rope_local=tables, rope_global=tables,
                    q_chunk=8)


def test_mla_alone_matches_the_reference():
    p = init_params(mla.mla_schema(SMALL), 3, device="cpu")
    p["kv_norm"]["w"] = 1 + 0.1 * torch.randn(SMALL.kv_lora_rank)
    x = torch.randn(B, S, SMALL.d_model, generator=torch.Generator()
                    .manual_seed(4))
    got = mla.mla_apply(p, x, _ctx(SMALL, S))
    want = ref.mla(p, x, ref_cfg(SMALL))
    _close(got, want, 2e-6)
    # causal: a later token changes no earlier output
    x2 = x.clone()
    x2[:, -1] += 1.0
    assert torch.equal(mla.mla_apply(p, x2, _ctx(SMALL, S))[:, :-1],
                       got[:, :-1])


def test_rope_rotates_interleaved_pairs():
    x = torch.randn(1, 5, 2, 8)
    cos, sin = rope_tables(torch.arange(5), 8, 50000.0)
    got = mla.rope_pairs(x, cos, sin)
    # pair (2, 3) of position 4 turns by 4 · 50000^(-2/8)
    a = 4 * 50000.0 ** (-2 / 8)
    c, s = torch.cos(torch.tensor(a)), torch.sin(torch.tensor(a))
    want = torch.stack([x[0, 4, :, 2] * c - x[0, 4, :, 3] * s,
                        x[0, 4, :, 3] * c + x[0, 4, :, 2] * s], -1)
    assert torch.allclose(got[0, 4, :, 2:4], want, atol=1e-6)
    assert torch.allclose(got, ref.rope(x, 50000.0), atol=1e-6)


def test_router_weights_come_from_s_not_s_plus_b():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3 * 8, SMALL.d_model, generator=gen)
    w_r = torch.randn(SMALL.d_model, 16, generator=gen) / 8
    bias = torch.zeros(16)
    bias[[3, 9]] = 10.0          # always chosen, whatever s says
    w, ids, aux = moe.sigmoid_route(w_r, bias, x, SMALL, 8)
    s = torch.sigmoid(x @ w_r)
    assert all({3, 9} <= set(row) for row in ids.tolist())
    assert torch.equal(ids, torch.topk(s + bias, 4, dim=-1).indices)
    chosen = s.gather(1, ids)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.446,
                          rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((24,), 2.446), rtol=1e-6)
    # the balance loss of a router that puts every sequence's slots evenly
    # on the experts is Σ_i (1/E)·1 over its normalised affinities = 1
    _, _, ref_aux = ref.route({"router": w_r, "bias": bias}, x,
                              ref_cfg(SMALL), 8)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)


def _moe_params(cfg, seed=6):
    p = init_params(moe.moe_schema(cfg), seed, device="cpu")
    p["bias"].copy_(0.05 * torch.randn(cfg.n_experts,
                                       generator=torch.Generator()
                                       .manual_seed(seed)))
    return p


def _moe_ref(cfg, p, x):
    return ref.moe(p, x, ref_cfg(cfg))


def test_dropless_a_router_forced_onto_one_held_expert_drops_nothing():
    p = _moe_params(CUT)
    p["bias"][CUT.held_first] = 10.0       # every token picks it
    x = torch.randn(B, S, CUT.d_model)
    got, aux = moe.moe_apply(p, x, CUT)
    want, raux = _moe_ref(CUT, p, x)
    _close(got, want, 2e-6)
    assert float(aux) == pytest.approx(float(raux), rel=1e-6)
    # every token's slot on the expert counts: with the expert's weights
    # zeroed only the shared experts and the other held expert remain
    cold = {k: v.clone() for k, v in p.items() if k != "shared"}
    cold["shared"] = p["shared"]
    for k in ("w_gate", "w_up", "w_down"):
        cold[k][0] = 0
    without, _ = moe.moe_apply(cold, x, CUT)
    assert bool(((got - without).abs().amax(-1) > 1e-4).all())


def test_the_shares_sum_to_the_uncut_layer():
    """Eight chips' shares of one MoE layer, the shared experts counted
    once, add up to the reference layer that holds all 16 experts."""
    p = _moe_params(SMALL)
    x = torch.randn(B, S, SMALL.d_model)
    full, _ = _moe_ref(SMALL, p, x)
    shared = ref.swiglu(p["shared"], x.reshape(-1, SMALL.d_model)
                        ).reshape(B, S, -1)
    total = shared.clone()
    for r in range(8):
        cut = moonlight.share(SMALL, ep=8, rank=r, vocab=SMALL.vocab)
        pr = dict(p)
        for k in ("w_gate", "w_up", "w_down"):
            pr[k] = p[k][2 * r:2 * r + 2]
        out, _ = moe.moe_apply(pr, x, cut)
        total = total + (out - shared)
    _close(total, full, 5e-6)


def test_the_train_step_matches_the_reference_and_keeps_the_bias():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=5,
                     eps=1e-3)
    params = _params(CUT)
    state = init_state(CUT, tc, device="cpu")
    flat = _leaves(state["params"])
    for k, v in _leaves(params).items():
        flat[k].copy_(v)
    assert not any(k.endswith("bias") for k in _leaves(state["opt"]["m"]))
    step = make_train_step(CUT, tc)
    rp = {k: v.clone() for k, v in _leaves(params).items()}
    trainable = {k: v for k, v in rp.items() if not k.endswith("bias")}
    opt = ref.AdamW(trainable, dataclasses.asdict(tc))
    for i in range(2):
        batch = _batch(CUT, seed=i)
        state, metrics = step(state, batch)
        live = {k: v.clone().requires_grad_(k in trainable)
                for k, v in rp.items()}
        rtotal, _, _ = ref.loss(_unflat(live), batch["tokens"],
                                batch["labels"], ref_cfg(CUT))
        keys = sorted(trainable)
        grads = torch.autograd.grad(rtotal, [live[k] for k in keys])
        opt.step(trainable, dict(zip(keys, grads)))
        assert float(metrics["total_loss"]) == pytest.approx(
            float(rtotal), rel=2e-6)
    got = _leaves(state["params"])
    for k, v in rp.items():
        if k.endswith("bias"):
            assert torch.equal(got[k], _leaves(params)[k])
        else:
            assert not torch.equal(got[k], _leaves(params)[k]), k
            _close(got[k] - _leaves(params)[k], v - _leaves(params)[k], 1e-4)


def test_prefill_and_decode_refuse_latent_attention():
    params = _params(CUT)
    with pytest.raises(NotImplementedError, match="MLA"):
        T.prefill(params, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                  CUT, cache_len=8)
    with pytest.raises(NotImplementedError, match="MLA"):
        T.decode_step(params, torch.zeros(1, 1, dtype=torch.long), {}, 0,
                      CUT)
