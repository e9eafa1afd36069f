"""Port parity: long-context decode on a mesh — the shape's rule table and
the JAX package's sequence-sharded KV cache (``cache_layout="seq"``) with
its flash-decode combine.

* **The combine alone** (one process): ``layers.decode_attention`` over a
  (B, T) cache equals ``combine_partials`` of ``decode_partials`` over the
  same cache cut into ``tp`` slices, within 1e-6 in f32 — with softcap,
  a window, GQA, slices that hold no valid position, and a ring — and
  JAX's ``decode_attention`` within 1e-6.
* **Sharded decode against JAX**: 4 gloo ranks as a (data 2 × model 2)
  mesh run reduced gemma2-2b (local + global layers, softcaps, GQA) in
  f32 on the JAX package's parameters. Under ``LONG_CONTEXT_RULES`` (B 1,
  every rank the whole batch) a prefill of 8 tokens and 4 decode steps
  hold their logits within 1e-5 of JAX's unsharded ``prefill`` /
  ``decode_step`` and of the unsharded port: with a cache of 12 slots
  (both model ranks hold valid positions) and of 32 slots with a window
  of 4 (the local layers keep replicated rings, and model rank 1's slice
  of the global caches holds no valid position in any step). Under
  ``DEFAULT_RULES`` (B 2 over ``data``) ``"seq"`` equals ``"heads"``.
  The decode collectives are counted per attention layer by name.

The ranks import ``torch`` and ``repro_torch`` only; the JAX references
run here, in the pytest process, on the same numpy inputs.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.config import reduced
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers as L

torch.set_num_threads(1)

TIMEOUT_S = 300
ARCH = "gemma2-2b"
P, GEN = 8, 4                     # prompt and decode steps
# (name, window override or None, rules, batch, cache length, layout)
RUNS = (("long12", None, "long", 1, P + GEN, "seq"),
        ("long32_ring", 4, "long", 1, 32, "seq"),
        ("default_seq", None, "default", 2, P + GEN, "seq"),
        ("default_heads", None, "default", 2, P + GEN, "heads"))
DECODE_NAMES = ("decode_qkv_gather", "decode_max", "decode_sum")
PREFILL_NAMES = ("cache_relayout", "cache_gather")


def _cfg(window):
    cfg = configs.smoke_config(ARCH)
    return cfg if window is None else reduced(configs.get_config(ARCH),
                                              window=window)


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (B, GEN)).astype(np.int32)
    return prompt, forced


# ---------------------------------------------------------------------------
# the combine alone
# ---------------------------------------------------------------------------

# (name, B, T, H, Hkv, hd, tp, window, softcap, pos, ring slots)
COMBINE = (("plain", 2, 16, 4, 4, 8, 2, 0, 0.0, 11, 0),
           ("gqa_softcap", 2, 16, 8, 2, 8, 4, 0, 50.0, 13, 0),
           ("window", 1, 16, 4, 2, 8, 4, 5, 30.0, 14, 0),
           ("empty_slices", 2, 16, 4, 1, 8, 4, 0, 0.0, 3, 0),
           ("ring", 2, 8, 4, 2, 8, 2, 8, 50.0, 20, 8))


@pytest.mark.parametrize("case", COMBINE, ids=[c[0] for c in COMBINE])
def test_flash_decode_combine_equals_decode_attention(case):
    import jax.numpy as jnp

    from repro.models.layers import decode_attention as j_decode_attention
    _, B, T, H, Hkv, hd, tp, window, softcap, pos, ring = case
    rng = np.random.default_rng(len(case[0]))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, 1, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    q *= 2.0   # scores of a few units: a softcap bends them
    kv_pos = (L._ring_slots(pos, ring) if ring else torch.arange(T))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(window=window, softcap=softcap)
    want = L.decode_attention(tq, tk, tv, kv_pos, pos, **kw)
    Tl = T // tp
    parts = [L.decode_partials(tq, tk[:, i * Tl:(i + 1) * Tl],
                               tv[:, i * Tl:(i + 1) * Tl],
                               kv_pos[i * Tl:(i + 1) * Tl], pos, **kw)
             for i in range(tp)]
    m, ssum, o = (torch.stack([p[j] for p in parts]) for j in range(3))
    valid = [(kv_pos[i * Tl:(i + 1) * Tl] <= pos).any().item()
             for i in range(tp)]
    if case[0] == "empty_slices":
        assert valid == [True, False, False, False]
        # an empty slice's partials are finite and weigh nothing
        assert torch.isfinite(ssum).all() and torch.isfinite(o).all()
        assert (m[1:] == L.NEG_INF).all()
    got = L.combine_partials(m, ssum, o).reshape(B, 1, H, hd)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jw = np.asarray(j_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kv_pos.numpy()), jnp.asarray(pos), **kw))
    np.testing.assert_allclose(got.numpy(), jw, rtol=1e-6, atol=1e-6)


def test_cache_layouts_share_global_shapes_and_differ_in_placement():
    from repro_torch.common.logical import to_physical
    from repro_torch.common.schema import param_logical_specs
    from repro_torch.models import transformer as TT
    cfg = configs.get_config(ARCH)
    seq = TT.stack_cache_schema_for(cfg, 1, 524288, 16, "seq")
    heads = TT.stack_cache_schema_for(cfg, 1, 524288, 16, "heads")
    glob, loc = seq["blocks"]["p1"]["attn"]["k"], \
        seq["blocks"]["p0"]["attn"]["k"]
    assert glob.shape == heads["blocks"]["p1"]["attn"]["k"].shape
    assert glob.logical == ("layers", "batch", "seq_kv", None, None)
    assert loc.shape[2] == cfg.window and \
        loc.logical == ("layers", "batch", None, None, None)
    mesh = meshlib.make_production_mesh()
    from repro_torch.launch.specs import LONG_CONTEXT_RULES
    specs = param_logical_specs(seq)
    assert to_physical(specs["blocks"]["p1"]["attn"]["k"], mesh,
                       LONG_CONTEXT_RULES) == (None, None, "model", None,
                                               None)
    with pytest.raises(ValueError, match="cache_layout"):
        TT.stack_cache_schema_for(cfg, 1, 64, layout="rows")


# ---------------------------------------------------------------------------
# sharded decode on 4 gloo ranks
# ---------------------------------------------------------------------------

def _serve(cfg, params, prompt, forced, cache_len, *, mesh=None,
           rules=None, layout="seq", counts=None):
    """Prefill ``prompt`` and decode ``forced``: (the logits of every
    step, the first layer's cache shape). ``counts``: a dict that gets
    the collective calls of the prefill and of the last decode step."""
    from repro_torch.common.logical import DEFAULT_RULES
    from repro_torch.core import collectives
    from repro_torch.train import step as TS
    kw = dict(mesh=mesh, rules=rules or DEFAULT_RULES, cache_layout=layout)
    pre = TS.make_prefill_step(cfg, cache_len=cache_len, **kw)
    dec = TS.make_decode_step(cfg, **kw)
    with torch.no_grad(), collectives.count_collectives() as c_pre:
        logits, caches = pre(params, {"tokens": torch.from_numpy(prompt)})
    seq = [logits.numpy()]
    with torch.no_grad():
        for i in range(GEN):
            with collectives.count_collectives() as c_dec:
                logits, caches = dec(params, torch.from_numpy(
                    forced[:, i:i + 1]), caches, P + i)
            seq.append(logits.numpy())
    if counts is not None:
        counts["prefill"] = dict(c_pre.calls)
        counts["decode"] = dict(c_dec.calls)
    shapes = {name: tuple(caches["blocks"][f"p{j}"]["attn"]["k"].shape)
              for j, name in enumerate(cfg.pattern)}
    return seq, shapes


def _long_rank(mesh, params_by_window, inputs):
    from repro_torch.common.logical import DEFAULT_RULES
    from repro_torch.common.schema import shard_params
    from repro_torch.launch.specs import LONG_CONTEXT_RULES
    from repro_torch.models import transformer as TT

    rules = {"long": LONG_CONTEXT_RULES, "default": DEFAULT_RULES}
    out = {}
    for name, window, rk, B, cache_len, layout in RUNS:
        cfg = _cfg(window)
        params = shard_params(TT.params_from_jax(params_by_window[window],
                                                 device="cpu"),
                              TT.model_schema(cfg), mesh)
        prompt, forced = inputs[(B, window)]
        counts = {}
        out[name] = _serve(cfg, params, prompt, forced, cache_len,
                           mesh=mesh, rules=rules[rk], layout=layout,
                           counts=counts) + (counts,)
    out["model_index"] = mesh.axis_index("model")
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def _jax_serve(jcfg, jp, prompt, forced, cache_len):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, jcfg, cache_len=cache_len))(jp, {"tokens": prompt})
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    seq = [np.asarray(logits)]
    for i in range(GEN):
        logits, caches = dec(jp, jnp.asarray(forced[:, i:i + 1]), caches,
                             jnp.asarray(P + i, jnp.int32))
        seq.append(np.asarray(logits))
    return seq


@pytest.fixture(scope="module")
def long_world():
    from _lm_parity import jax_params
    from repro import configs as jconfigs
    from repro.common.config import reduced as j_reduced
    from repro_torch.models import transformer as TT

    jcfgs = {None: jconfigs.smoke_config(ARCH),
             4: j_reduced(jconfigs.get_config(ARCH), window=4)}
    params = {w: jax_params(c, 0) for w, c in jcfgs.items()}
    inputs = {(B, w): _inputs(_cfg(w), B, B)
              for _, w, _, B, _, _ in RUNS}
    ref = {}
    for name, window, _, B, cache_len, _ in RUNS:
        prompt, forced = inputs[(B, window)]
        jseq = _jax_serve(jcfgs[window], params[window], prompt, forced,
                          cache_len)
        port, _ = _serve(_cfg(window),
                         TT.params_from_jax(params[window], device="cpu"),
                         prompt, forced, cache_len)
        ref[name] = (jseq, port)
    ranks = meshlib.spawn(_long_rank, (2, 2), backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S, args=(params, inputs))
    return ranks, ref


def test_ranks_import_no_jax(long_world):
    assert all(r["modules"] == [] for r in long_world[0])


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_sharded_decode_matches_jax_and_the_unsharded_port(long_world,
                                                           name):
    ranks, ref = long_world
    jseq, port = ref[name]
    cfg = _cfg(dict((r[0], r[1]) for r in RUNS)[name])
    V = cfg.vocab
    for r in ranks:
        seq = r[name][0]
        assert len(seq) == len(jseq) == GEN + 1
        for got, jw, pw in zip(seq, jseq, port):
            np.testing.assert_allclose(got[:, :V], jw[:, :V], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[:, :V], pw[:, :V], rtol=1e-5,
                                       atol=1e-5)


def test_seq_equals_heads_under_the_default_rules(long_world):
    for r in long_world[0]:
        for a, b in zip(r["default_seq"][0], r["default_heads"][0]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_caches_hold_a_sequence_slice_of_every_kv_head(long_world):
    """``"seq"``: a global layer's cache is the rank's rows (all of them
    under the long-context rules) of T/2 slots and every kv head; a local
    layer's ring keeps its window on every rank. ``"heads"``: every slot
    of the rank's kv head."""
    cfg = configs.smoke_config(ARCH)
    hd, Hkv, n = cfg.hd, cfg.n_kv_heads, cfg.n_layers // 2
    for r in long_world[0]:
        assert r["long12"][1] == {"local": (n, 1, 6, Hkv, hd),
                                  "attn": (n, 1, 6, Hkv, hd)}
        assert r["long32_ring"][1] == {"local": (n, 1, 4, Hkv, hd),
                                       "attn": (n, 1, 16, Hkv, hd)}
        assert r["default_seq"][1]["attn"] == (n, 1, 6, Hkv, hd)
        assert r["default_heads"][1]["attn"] == (n, 1, P + GEN, Hkv // 2,
                                                 hd)


def test_decode_collectives_per_attention_layer(long_world):
    """Per decode step and layer: one one-token gather of q, k, v over
    model, and one max and one sum all-reduce where the cache is
    sequence-sharded (a ring needs no combine); per prefill layer one
    relayout all_to_all of a sequence-sharded cache and one gather of a
    ring's heads. Under the long-context rules no batch gather; under
    the default rules one ``result_gather`` of the rows over data, and
    the ``"heads"`` layout none of the names."""
    ranks = long_world[0]
    n = configs.smoke_config(ARCH).n_layers
    want = {"long12": ({"decode_qkv_gather": n, "decode_max": n,
                        "decode_sum": n}, {"cache_relayout": n}),
            "long32_ring": ({"decode_qkv_gather": n, "decode_max": n // 2,
                             "decode_sum": n // 2},
                            {"cache_relayout": n // 2,
                             "cache_gather": n // 2}),
            "default_seq": ({"decode_qkv_gather": n, "decode_max": n,
                             "decode_sum": n}, {"cache_relayout": n}),
            "default_heads": ({}, {})}
    for r in ranks:
        for name, (dec, pre) in want.items():
            counts = r[name][2]
            assert {k: counts["decode"].get(k, 0) for k in DECODE_NAMES
                    if counts["decode"].get(k)} == dec, name
            assert {k: counts["prefill"].get(k, 0) for k in PREFILL_NAMES
                    if counts["prefill"].get(k)} == pre, name
            gathered = counts["decode"].get("result_gather", 0)
            assert gathered == (1 if name.startswith("default") else 0)
