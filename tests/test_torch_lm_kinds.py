"""Port parity: the layer kinds ``ssd`` (``models/ssm.py``), ``rglru``
(``models/griffin.py``), ``moe`` (``models/moe.py``) and ``cross``, and the
seven architectures built from them, against the JAX package.

Layers are held at 1e-5 on O(1) inputs (the SSD chunk loop and the
log-depth RG-LRU scan sum in other orders than ``lax.scan`` and
``lax.associative_scan``). Each architecture runs reduced prefill and 4
decode steps on parameters drawn by the JAX package
(``_lm_parity.jax_params``), the decode inputs the JAX package's greedy
tokens, logits within rtol 1e-4, atol 2e-4, and one ``make_train_step``
step (loss 1e-4, parameters 1e-5 at ``_lm_parity.TRAIN_KW``). The
configurations, their full-width parameter counts (from the schema, no
allocation) and the (arch × shape) cells equal the JAX registry's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import (TRAIN_KW, assert_trees, config_fields, jax_draw,
                        jax_params, shapes, states)
from repro import configs as jconfigs
from repro.common.schema import count_params as j_count_params
from repro.common.schema import init_params as j_init_params
from repro.data import TokenStream as JTokenStream
from repro.models import griffin as JG
from repro.models import moe as JM
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs
from repro_torch.common.schema import ParamDef, count_params, init_params
from repro_torch.launch import serve
from repro_torch.models import griffin as TG
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

NEW_ARCHS = ["gemma3-12b", "phi3-medium-14b", "deepseek-moe-16b",
             "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "mamba2-780m",
             "recurrentgemma-2b"]
TOL = dict(rtol=1e-5, atol=1e-5)
B, P, STEPS = 2, 8, 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer_params(schema, seed):
    """A layer's JAX-drawn parameters (``jax_draw``) as numpy and as port
    tensors."""
    jp = jax_draw(schema, seed)
    return jp, TT.params_from_jax(jp, device="cpu")


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, S=24):
    Bsz, H, P_, N = 2, 3, 4, 5
    return (rng.standard_normal((Bsz, S, H, P_)).astype(np.float32),
            (rng.random((Bsz, S, H)) * 0.5).astype(np.float32),
            (-rng.random(H) * 2).astype(np.float32),
            rng.standard_normal((Bsz, S, N)).astype(np.float32),
            rng.standard_normal((Bsz, S, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 7])            # 7: the padded path
def test_ssd_chunked_matches(rng, chunk):
    args = _ssd_inputs(rng)
    s0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    for init in (None, s0):
        jy, js = JSSM.ssd_chunked(*args, chunk, init_state=init)
        ty, ts = TSSM.ssd_chunked(*map(_t, args), chunk,
                                  init_state=None if init is None
                                  else _t(init))
        assert ty.dtype == ts.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), jy, **TOL)
        np.testing.assert_allclose(ts.numpy(), js, **TOL)


def _ssd_cfg():
    return configs.smoke_config("mamba2-780m")


def test_ssd_apply_and_decode_match(rng):
    cfg = _ssd_cfg()
    jcfg = jconfigs.smoke_config("mamba2-780m")
    jp, tp = _layer_params(JSSM.ssd_schema(jcfg), 1)
    assert shapes(TSSM.ssd_schema(cfg)) == shapes(JSSM.ssd_schema(jcfg))
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda p, x: JSSM.ssd_apply(p, x, jcfg,
                                                 return_cache=True))(jp, x)
    to, tc = TSSM.ssd_apply(tp, _t(x), cfg, return_cache=True)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert_trees(tc, jc, **TOL)
    assert shapes(tc) == shapes(TSSM.ssd_cache_schema(cfg, 2))
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda p, x, c: JSSM.ssd_decode(p, x, c, jcfg))(
        jp, x1, jc)
    to, tc = TSSM.ssd_decode(tp, _t(x1), tc, cfg)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert_trees(tc, jc, **TOL)


# ---------------------------------------------------------------------------
# rglru
# ---------------------------------------------------------------------------

def test_linear_scan_equals_the_recurrence(rng):
    a = rng.random((2, 37, 5)).astype(np.float32)
    b = rng.standard_normal((2, 37, 5)).astype(np.float32)
    h, want = np.zeros((2, 5), np.float32), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    aa, got = TG.linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **TOL)
    np.testing.assert_allclose(aa.numpy(), np.cumprod(a, axis=1), **TOL)


def test_rglru_apply_and_decode_match(rng):
    jcfg = jconfigs.smoke_config("recurrentgemma-2b")
    cfg = configs.smoke_config("recurrentgemma-2b")
    jp, tp = _layer_params(JG.rglru_schema(jcfg), 2)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    hist = rng.standard_normal((2, cfg.conv_kernel - 1, cfg.lru_width)
                               ).astype(np.float32)
    jo = jax.jit(lambda p, x, h, c: JG.rglru_apply(
        p, x, jcfg, init_h=h, conv_history=c))(jp, x, h0, hist)
    to = TG.rglru_apply(tp, _t(x), cfg, init_h=_t(h0), conv_history=_t(hist))
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    jo, jc = jax.jit(lambda p, x: JG.rglru_apply(p, x, jcfg,
                                                 return_cache=True))(jp, x)
    to, tc = TG.rglru_apply(tp, _t(x), cfg, return_cache=True)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert_trees(tc, jc, **TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda p, x, c: JG.rglru_decode(p, x, c, jcfg))(
        jp, x1, jc)
    to, tc = TG.rglru_decode(tp, _t(x1), tc, cfg)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert_trees(tc, jc, **TOL)


def test_custom_inits_draw_the_reference_ranges():
    """The custom inits' values lie where the JAX package's do: RG-LRU's
    a^c in [0.9, 0.999], SSD's A in [1, 16] and softplus(dt_bias) in
    [1e-3, 1e-1], on both draws."""
    schema = {"lam": ParamDef((4096,), (None,), init="custom",
                              custom="rglru_lambda"),
              "a_log": ParamDef((4096,), (None,), init="custom",
                                custom="ssm_a_log"),
              "dt_bias": ParamDef((4096,), (None,), init="custom",
                                  custom="ssm_dt_bias")}
    for draw in ("numpy", "device"):
        p = init_params(schema, 0, device="cpu", draw=draw)
        a8 = torch.exp(-8 * torch.nn.functional.softplus(p["lam"]))
        assert 0.9 ** 2 - 1e-5 <= float(a8.min()) and \
            float(a8.max()) <= 0.999 ** 2 + 1e-5
        A = torch.exp(p["a_log"])
        assert 1 - 1e-5 <= float(A.min()) and float(A.max()) <= 16 + 1e-4
        dt = torch.nn.functional.softplus(p["dt_bias"])
        assert 1e-3 * (1 - 1e-4) <= float(dt.min()) and \
            float(dt.max()) <= 1e-1 * (1 + 1e-4)
        assert torch.equal(p["lam"], init_params(schema, 0, device="cpu",
                                                 draw=draw)["lam"])


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

def _moe_world(rng, arch="deepseek-moe-16b", S=16):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jp, tp = _layer_params(JM.moe_schema(jcfg), 3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def test_moe_route_matches(rng):
    jcfg, cfg, jp, tp, x = _moe_world(rng)
    jw, jids, jaux = jax.jit(lambda w, x: JM.route(w, x, jcfg))(
        jp["router"], x)
    tw, tids, taux = TM.route(tp["router"], _t(x), cfg)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tw.numpy(), jw, **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("factor", [0.5, 4.0])      # 0.5 drops slots
def test_moe_apply_matches_with_capacity_drops(rng, factor):
    jcfg, cfg, jp, tp, x = _moe_world(rng)
    assert "shared" in tp
    def jmoe(p, x):
        return JM.moe_apply(p, x, jcfg, capacity_factor=factor,
                            group_size=8)

    jo, jaux = jax.jit(jmoe)(jp, x)
    to, taux = TM.moe_apply(tp, _t(x), cfg, capacity_factor=factor,
                            group_size=8)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert taux.dtype == torch.float32
    # the dropped slots: capacity C per (group, expert) queue
    _, ids, _ = TM.route(tp["router"], _t(x).reshape(4, 8, -1), cfg)
    C = TM._capacity(8, cfg.n_experts, cfg.top_k, factor)
    per_queue = torch.nn.functional.one_hot(ids, cfg.n_experts).sum((1, 2))
    assert bool((per_queue > C).any()) == (factor < 1)
    # gradients through the dispatch and combine einsums
    live = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    out, aux = TM.moe_apply(live, _t(x), cfg, capacity_factor=factor,
                            group_size=8)
    (out.sum() + aux).backward()
    jg = jax.jit(jax.grad(lambda p, x: (lambda o, a: o.sum() + a)(
        *jmoe(p, x))))(jp, x)
    assert_trees(jax.tree.map(lambda t: t.grad, live), jg, rtol=1e-4,
                 atol=1e-4)


def test_moe_group_reshape_fails_as_the_reference():
    """More than 512 tokens that are not a multiple of 512 fail the group
    reshape in both packages."""
    cfg = configs.smoke_config("deepseek-moe-16b")
    tp = init_params(TM.moe_schema(cfg), 0, device="cpu")
    x = torch.zeros(1, 600, cfg.d_model)
    with pytest.raises(RuntimeError, match="shape"):
        TM.moe_apply(tp, x, cfg)
    jcfg = jconfigs.smoke_config("deepseek-moe-16b")
    jp = j_init_params(JM.moe_schema(jcfg), jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        JM.moe_apply(jp, jnp.zeros((1, 600, jcfg.d_model)), jcfg)


# ---------------------------------------------------------------------------
# cross
# ---------------------------------------------------------------------------

def test_cross_layer_matches(rng):
    jcfg = jconfigs.smoke_config("llama-3.2-vision-90b")
    cfg = configs.smoke_config("llama-3.2-vision-90b")
    jp, tp = _layer_params(JT.layer_schema(jcfg, "cross"), 4)
    # open the tanh gates (zero at init) so the layer is not the identity
    for p in (jp, tp):
        p["attn"]["gate_attn"] = p["attn"]["gate_attn"] + 0.7
        p["mlp"]["gate_ffn"] = p["mlp"]["gate_ffn"] - 0.4
    S = 12
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.vision_seq, cfg.d_model)).astype(
        np.float32)
    jctx = JT._make_ctx(jcfg, jnp.arange(S), memory=mem)
    tctx = TT._make_ctx(cfg, torch.arange(S), memory=_t(mem))
    jo, _ = jax.jit(lambda p, x: JT.layer_apply(jcfg, "cross", p, x, jctx)
                    )(jp, x)
    to, _ = TT.layer_apply(cfg, "cross", tp, _t(x), tctx)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    jo, jc = jax.jit(lambda p, x: JT.layer_prefill(jcfg, "cross", p, x, jctx,
                                                   16))(jp, x)
    to, tc = TT.layer_prefill(cfg, "cross", tp, _t(x), tctx, 16)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    assert_trees(tc, jc, **TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jctx = JT._make_ctx(jcfg, jnp.asarray([S]), pos=jnp.asarray(S))
    tctx = TT._make_ctx(cfg, torch.tensor([S]), pos=S)
    jo, _ = jax.jit(lambda p, x, c: JT.layer_decode(jcfg, "cross", p, x, c,
                                                    jctx))(jp, x1, jc)
    to, _ = TT.layer_decode(cfg, "cross", tp, _t(x1), tc, tctx)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)


# ---------------------------------------------------------------------------
# the seven architectures: configs, schemas, serving and one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_and_full_width_counts_match(arch):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    mine, theirs = config_fields(tcfg, jcfg)
    assert mine == theirs
    mine, theirs = config_fields(configs.smoke_config(arch),
                                 jconfigs.smoke_config(arch))
    assert mine == theirs
    js, ts = JT.model_schema(jcfg), TT.model_schema(tcfg)
    assert count_params(ts) == j_count_params(js)
    assert shapes(ts) == shapes(js)
    if not jcfg.is_encoder_decoder:
        assert shapes(TT.stack_cache_schema_for(tcfg, 2, 64)) == \
            shapes(JT.stack_cache_schema_for(jcfg, 2, 64))


def test_registry_and_cells_match():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(include_skipped=True) == \
        jconfigs.cells(include_skipped=True)
    assert configs.SKIP_CELLS == jconfigs.SKIP_CELLS
    assert dataclasses.asdict(configs.get_shape("long_500k")) == \
        dataclasses.asdict(jconfigs.get_shape("long_500k"))


def _jax_serve(cfg, params, batch):
    cache_len = P + STEPS + 1
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, cfg, cache_len=cache_len))(params, batch)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, cfg))
    out, tokens = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, caches = dec(params, tok, caches, jnp.asarray(P + i,
                                                              jnp.int32))
        out.append(np.asarray(logits))
    return out, np.concatenate(tokens, axis=1)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_and_a_train_step_match(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jp = jax_params(jcfg, P + STEPS + 1)
    batch = serve.lm_batch(tcfg, B, P, seed=0)
    want, tokens = _jax_serve(jcfg, jp, batch)
    out = serve.generate(TT.params_from_jax(jp, device="cpu"), batch, tcfg,
                         gen=STEPS + 1, use_flash=False,
                         forced=torch.from_numpy(tokens))
    assert len(out["logits"]) == STEPS + 1
    for g, w in zip(out["logits"], want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=2e-4)
    np.testing.assert_array_equal(out["tokens"][:, :STEPS].numpy(), tokens)

    # one train step from the same parameters
    jstate, tstate, jtc, ttc = states(jp, **TRAIN_KW)
    tb = JTokenStream(vocab=jcfg.vocab, batch=B, seq_len=16,
                      with_vision=jcfg.vision_seq,
                      d_model=jcfg.d_model).batch_at(0)
    jstate, jm = jax.jit(JS.make_train_step(jcfg, jtc))(jstate, tb)
    tstate, tm = TS.make_train_step(tcfg, ttc)(tstate, tb)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert (float(tm["aux_loss"]) > 0) == ("moe" in tcfg.pattern)
    assert_trees(tstate["params"], jstate["params"], rtol=1e-5, atol=1e-5)
