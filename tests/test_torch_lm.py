"""Port parity: the LM serving path (``models/``, ``train/step.py``,
``launch/serve.py``'s LM workload) against the JAX package.

Layers are held at 1e-6 on O(1) inputs. Whole models — reduced
whisper-base (encoder and decoder prefill self-attention on the flash
kernel's plain version, where the JAX package's prefill stays chunked, and
all on the chunked attention), qwen1.5-0.5b and gemma2-2b — run prefill and 4 decode
steps on parameters drawn by the JAX package and carried across with
``params_from_jax``; the decode inputs are the JAX package's greedy
tokens, and the port's greedy tokens must equal them; logits agree within
rtol = 1e-4, atol = 2e-4.

The JAX ``lecun`` init takes a stacked leaf's first axis, the layer count,
as its fan-in, so its stacked matrices come out several times too large
(reduced whisper-base's attention logits reach ~1e3). There two f32
summation orders part by more than 2e-4: the JAX package's own flash and
chunked paths already differ by several times that at a decode step.
The parity test therefore draws each stacked matrix at one layer's fan-in
(rescaling the JAX draw, the scale the port's ``init_params`` uses); a
second test keeps the JAX init as it is and holds whisper-base's logits
within 1e-3 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import config_fields
from repro import configs as jconfigs
from repro.common.schema import ParamDef as JParamDef
from repro.common.schema import init_params as j_init_params
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.common.schema import (ParamDef, count_params, init_params,
                                       stack)
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.common.config import TrainConfig
from repro_torch.train import (make_decode_step, make_prefill_step,
                               make_train_step)

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

ARCHS = ["whisper-base", "qwen1.5-0.5b", "gemma2-2b"]
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
B, P, STEPS = 2, 8, 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [False, True])
def test_norms_match(rng, zero_centered):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w), 1e-6, zero_centered),
           JL.rms_norm(x, w, 1e-6, zero_centered), **LAYER_TOL)
    _close(TL.layer_norm(_t(x), _t(w), _t(b), 1e-5),
           JL.layer_norm(x, w, b, 1e-5), **LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(rng, theta):
    x = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    jc, js = JL.rope_tables(jnp.arange(64), 16, theta)
    tc, ts = TL.rope_tables(torch.arange(64), 16, theta)
    _close(tc, jc, **LAYER_TOL)
    _close(ts, js, **LAYER_TOL)
    _close(TL.apply_rope(_t(x), tc, ts), JL.apply_rope(x, jc, js),
           **LAYER_TOL)


@pytest.mark.parametrize("q_chunk", [16, 1024])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=20, softcap=30.0),
                                dict(causal=False)])
def test_chunked_attention_matches(rng, kw, q_chunk):
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32) * 0.25
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    _close(TL.chunked_attention(_t(q), _t(k), _t(v), q_chunk=q_chunk, **kw),
           JL.chunked_attention(q, k, v, q_chunk=q_chunk, **kw), **LAYER_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 20.0)])
def test_decode_attention_matches(rng, window, softcap):
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32) * 0.25
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    kv_pos = np.arange(64)
    kv_pos[50:] = -1                     # slots not written yet
    got = TL.decode_attention(_t(q), _t(k), _t(v), _t(kv_pos), 40,
                              window=window, softcap=softcap)
    want = JL.decode_attention(q, k, v, jnp.asarray(kv_pos), jnp.asarray(40),
                               window=window, softcap=softcap)
    _close(got, want, **LAYER_TOL)


@pytest.mark.parametrize("W", [4, 8])
def test_ring_slots_match(W):
    for pos in range(0, 3 * W):
        assert TL._ring_slots(pos, W).tolist() == \
            np.asarray(JL._ring_slots(jnp.asarray(pos), W)).tolist()


def test_local_prefill_fills_the_ring_as_jax(rng):
    """A local layer whose window is shorter than the cache keeps the last
    ``window`` keys in ring order; decode then writes slot pos % window."""
    jcfg = jconfigs.smoke_config("gemma2-2b")
    tcfg = configs.smoke_config("gemma2-2b")
    S, cache_len = 40, 48                       # window 32 < cache_len
    jp = jax.tree.map(np.asarray, j_init_params(
        JL.attn_schema(jcfg), jax.random.PRNGKey(3)))
    tp = TT.params_from_jax(jp, device="cpu")
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jctx = JT._make_ctx(jcfg, jnp.arange(S))
    tctx = TT._make_ctx(tcfg, torch.arange(S))
    jo, jc = JL.attn_prefill(jp, x, jctx, kind="local", cache_len=cache_len)
    to, tc = TL.attn_prefill(tp, _t(x), tctx, kind="local",
                             cache_len=cache_len)
    assert tc["k"].shape == (B, jcfg.window, jcfg.n_kv_heads, jcfg.hd)
    _close(to, jo, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], rtol=1e-5, atol=1e-5)
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jctx = JT._make_ctx(jcfg, jnp.asarray([S]), pos=jnp.asarray(S))
    tctx = TT._make_ctx(tcfg, torch.tensor([S]), pos=S)
    jo, jc = JL.attn_decode(jp, x1, jc, jctx, kind="local")
    to, tc = TL.attn_decode(tp, _t(x1), tc, tctx, kind="local")
    _close(to, jo, rtol=1e-5, atol=1e-5)
    _close(tc["k"], jc["k"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# schemas and parameters
# ---------------------------------------------------------------------------

def _shapes(tree, path=()):
    if not isinstance(tree, dict):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, (*path, k)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_schemas_match_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    mine, theirs = config_fields(tcfg, jcfg)
    assert mine == theirs
    js = JT.model_schema(jcfg, max_seq=64)
    ts = TT.model_schema(tcfg, max_seq=64)
    assert _shapes(ts) == _shapes(js)
    assert count_params(ts) == sum(np.prod(s) for s in _shapes(js).values())
    jc = JT.stack_cache_schema_for(jcfg, 3, 64)
    tc = TT.stack_cache_schema_for(tcfg, 3, 64)
    assert _shapes(tc) == _shapes(jc)


def test_init_params_nested_inits_and_dtypes():
    schema = {
        "a": {"w": ParamDef((64, 32), (None, None), init="lecun"),
              "n": ParamDef((32,), (None,), init="ones")},
        "emb": ParamDef((500, 8), (None, None), init="normal", scale=1.0),
        "pos": ParamDef((300, 8), (None, None), init="normal"),
        "z": ParamDef((4,), (None,), init="zeros", dtype=torch.bfloat16),
        "blocks": stack({"w": ParamDef((256, 16), (None, None))}, 3),
    }
    p = init_params(schema, 5, device="cpu")
    again = init_params(schema, 5, device="cpu")
    assert set(p) == {"a", "emb", "pos", "z", "blocks"}
    assert torch.equal(p["a"]["w"], again["a"]["w"])
    assert p["a"]["n"].eq(1).all() and p["z"].eq(0).all()
    assert p["z"].dtype == torch.bfloat16 and p["a"]["w"].dtype == torch.float32
    assert abs(float(p["emb"].std()) - 1.0) < 0.1
    assert abs(float(p["pos"].std()) - 0.02) < 0.005
    assert abs(float(p["a"]["w"].std()) - 64 ** -0.5) < 0.02
    # a stacked matrix is drawn with one layer's fan-in, not the layer count
    assert p["blocks"]["w"].shape == (3, 256, 16)
    assert abs(float(p["blocks"]["w"].std()) - 256 ** -0.5) < 0.01
    with pytest.raises(ValueError, match="unknown init"):
        init_params({"x": ParamDef((2,), (None,), init="custom")},
                    device="cpu")


def test_params_from_jax_keeps_nesting_and_dtype():
    cfg = jconfigs.smoke_config("whisper-base")
    jp = j_init_params(JT.model_schema(cfg, max_seq=16), jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert _shapes(tp) == _shapes(jp)
    w = tp["encoder"]["blocks"]["p0"]["attn"]["wq"]
    assert w.shape[0] == cfg.n_enc_layers and w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jp["encoder"]["blocks"]["p0"]["attn"]["wq"]))
    half = TT.params_from_jax({"c": {"k": np.asarray(
        jnp.ones((2, 3), jnp.bfloat16))}}, device="cpu")
    assert half["c"]["k"].dtype == torch.bfloat16


def test_unported_parts_raise_naming_their_row():
    """``mesh=`` on every LM step, on the loss and on the lookup takes the
    port's named-axis ``Mesh`` (the sharded LM,
    ``tests/test_torch_sharded_lm.py``): anything else raises a
    ``TypeError`` naming it."""
    cfg = configs.smoke_config("qwen1.5-0.5b")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        make_prefill_step(cfg, cache_len=8, mesh=object())
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        make_decode_step(cfg, mesh=object())
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        make_train_step(cfg, TrainConfig(), mesh=object())
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        TT.loss_fn({"embed": {"table": torch.zeros(4, 2)}}, {}, cfg,
                   mesh=object())
    from repro_torch.models.embedding import embed_lookup
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        embed_lookup(torch.zeros(4, 2), torch.zeros(1, 1), mesh=object())


# ---------------------------------------------------------------------------
# whole models: prefill + 4 decode steps against the JAX package
# ---------------------------------------------------------------------------

def _jax_params(cfg, *, per_layer_fan_in=True):
    """The JAX package's parameters for ``cfg`` as numpy arrays; with
    ``per_layer_fan_in``, each stacked ``lecun`` matrix rescaled from the
    layer count's fan-in to one layer's."""
    schema = JT.model_schema(cfg, max_seq=P + STEPS + 1)

    def leaf(d, a):
        a = np.asarray(a)
        if per_layer_fan_in and d.init == "lecun" and \
                d.logical[:1] == ("layers",) and len(d.shape) >= 3:
            a = a * np.float32(np.sqrt(d.shape[0] / d.shape[1]))
        return a

    return jax.tree.map(leaf, schema, j_init_params(schema,
                                                    jax.random.PRNGKey(0)),
                        is_leaf=lambda x: isinstance(x, JParamDef))


def _jax_run(cfg, params, batch, use_flash):
    cache_len = P + STEPS + 1
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, cfg, cache_len=cache_len, use_flash=use_flash))(params, batch)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, cfg))
    out, tokens = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, caches = dec(params, tok, caches, jnp.asarray(P + i,
                                                              jnp.int32))
        out.append(np.asarray(logits))
    return out, np.concatenate(tokens, axis=1)


def _port_run(arch, jp, use_flash):
    """(port logits, port greedy tokens, JAX logits, JAX greedy tokens);
    the port's decode inputs are the JAX package's greedy tokens."""
    jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    batch = serve.lm_batch(tcfg, B, P, seed=0)
    want, tokens = _jax_run(jcfg, jp, batch, use_flash)
    FK.reset_launch_counts()
    out = serve.generate(TT.params_from_jax(jp, device="cpu"), batch, tcfg,
                         gen=STEPS + 1, use_flash=use_flash,
                         forced=torch.from_numpy(tokens))
    # the encoder's layers and every decoder layer's prefill
    assert FK.flash_attention_plain.calls == (
        tcfg.n_enc_layers + tcfg.n_layers if use_flash else 0)
    assert len(out["logits"]) == len(want) == STEPS + 1
    return ([x.numpy() for x in out["logits"]], out["tokens"].numpy(), want,
            tokens)


@pytest.mark.parametrize("arch,use_flash", [
    ("whisper-base", True), ("whisper-base", False),
    ("qwen1.5-0.5b", False), ("gemma2-2b", False)])
def test_prefill_and_decode_match_jax(arch, use_flash):
    jp = _jax_params(jconfigs.smoke_config(arch))
    got, got_tokens, want, tokens = _port_run(arch, jp, use_flash)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-4)
    np.testing.assert_array_equal(got_tokens[:, :STEPS], tokens)
    np.testing.assert_array_equal(got_tokens[:, STEPS], want[-1].argmax(-1))


def test_whisper_matches_jax_on_the_jax_init():
    jp = _jax_params(jconfigs.smoke_config("whisper-base"),
                     per_layer_fan_in=False)
    got, _, want, _ = _port_run("whisper-base", jp, True)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3 * scale)


def test_decode_step_updates_caches_in_place(rng):
    cfg = configs.smoke_config("qwen1.5-0.5b")
    params = init_params(TT.model_schema(cfg), 0, device="cpu")
    batch = serve.lm_batch(cfg, B, P, seed=0)
    logits, caches = make_prefill_step(cfg, cache_len=P + 2)(params, batch)
    k = caches["blocks"]["p0"]["attn"]["k"]
    assert k.shape == (cfg.n_layers, B, P + 2, cfg.n_kv_heads, cfg.hd)
    assert k[:, :, P:].eq(0).all()
    _, again = make_decode_step(cfg)(params, logits.argmax(-1)[:, None],
                                     caches, P)
    assert again["blocks"]["p0"]["attn"]["k"] is k
    assert k[:, :, P].ne(0).any() and k[:, :, P + 1].eq(0).all()


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_launcher_lm_workload_runs_on_the_cpu(capsys, impl):
    rc = serve.main(["--workload", "lm", "--arch", "whisper-base", "--reduced",
                     "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                     "--gen", "4", "--impl", impl])
    out = capsys.readouterr().out
    assert rc == 0
    assert "whisper-base on cpu" in out and "ms/step" in out
    assert "generated ids[0]:" in out
