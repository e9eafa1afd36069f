"""Port parity: the sharded LM on gloo ranks on the CPU.

Two spawns serve the file (module fixtures); the ranks import ``torch``
and ``repro_torch`` only, and the JAX references run here, in the pytest
process, on the same numpy inputs.

* a (data 2 × model 2) mesh of 4 ranks: reduced qwen1.5-0.5b on
  parameters drawn by the JAX package (``_lm_parity.jax_params``) —
  ``loss_fn`` and its gradients within 1e-5 of the JAX package's
  unsharded ``loss_fn``; two ``make_train_step`` steps with 1 and with 2
  microbatches against the JAX step (metrics within 1e-4, parameters
  within 1e-5); prefill (plain, and with ``use_flash=True``, the flash
  kernel's plain version on the local heads) plus 4 decode steps within
  rtol 1e-4, atol 2e-4 on the JAX package's greedy tokens, the plain
  prefill's caches in the ``"heads"`` layout (the rank's rows and kv
  heads) and the flash prefill's in the JAX package's ``"seq"`` layout
  (the rank's sequence slice of every kv head). Then reduced gemma3-12b's loss
  and gradients (q and k norms on split heads) and one step each of
  deepseek-moe-16b (experts over ``model``), mamba2-780m and
  recurrentgemma-2b against the unsharded port.
* 8 ranks, as a (2, 4), a (4, 2) and a (2, 2, 2) mesh: ``embed_lookup``
  on 2 × 4 (the mirror of ``distributed_cases.py``'s embedding case):
  values equal ``table[ids]``, and the gradient equals the dense one-hot
  gradient and the JAX package's unsharded ``jax.grad`` for ``impl`` in
  {ref, kernel} × ``request_chunk`` in {None, 5}; the baseline's
  ``table_gather`` (counts and bytes, the divergence of ROADMAP Queue 3
  row 3) and the three ``embed_lookup`` contracts counted clean; qwen's
  loss and gradients with the q heads split and the kv heads not (2 × 4)
  and over a pod axis (2 × 2 × 2); prefill and decode in the ``"seq"``
  layout where only the q heads split (qwen on 2 × 4) and where neither
  does (gemma2-2b on 1 × 8, most ranks' slices empty) against the
  unsharded port; the elastic checkpoint (save on
  (4, 2), restore on (2, 4) with shard shape (16, 2), and whole) and the
  JAX package restoring the sharded save; ``pipelined_apply`` over
  ``pod`` against the sequential blocks, values and gradients.
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as meshlib

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores (every spawned rank sets the same).
torch.set_num_threads(1)

TIMEOUT_S = 600
ARCH = "qwen1.5-0.5b"
B, S = 4, 8              # the global batch: 2 rows per data rank
P, GEN = 8, 4            # prompt and decode steps
SEQ_T = P + GEN + 2       # a "seq" cache: its slots split over model
SMOKE = ("deepseek-moe-16b", "mamba2-780m", "recurrentgemma-2b")
TRAIN_STEPS = 2


def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.vision_seq:
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# helpers the ranks run
# ---------------------------------------------------------------------------

def _full(tree, schema_specs, mesh):
    """Every leaf of a tree of blocks gathered to its full shape, as
    numpy, keyed by path."""
    from repro_torch.common.logical import gather_leaf, spec_leaves
    from repro_torch.common.tree import leaves_with_paths
    specs = dict(spec_leaves(schema_specs))
    return {p: gather_leaf(v, specs[p], mesh).numpy()
            for p, v in leaves_with_paths(tree)}


def _loss_and_grads(cfg, params, batch, mesh):
    """(loss, metrics, full gradients) of ``loss_fn`` on ``mesh``: each
    rank's rows, the gradients summed over the batch axes as the train
    step sums them, then gathered."""
    from repro_torch.common.logical import tree_to_physical
    from repro_torch.common.schema import param_logical_specs
    from repro_torch.common.tree import tree_map
    from repro_torch.models import transformer as TT
    from repro_torch.train import step as TS
    specs = tree_to_physical(param_logical_specs(TT.model_schema(cfg)),
                             mesh)
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    rows = TS._rows({k: torch.from_numpy(v) for k, v in batch.items()},
                    cfg, mesh)
    total, metrics = TT.loss_fn(live, rows, cfg, mesh=mesh)
    total.backward()
    grads = TS._sync_grads(tree_map(lambda t: t.grad, live), specs, mesh)
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            _full(grads, specs, mesh))


def _model_rank(mesh, jp, train_kw, forced):
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.logical import tree_to_physical
    from repro_torch.common.schema import (init_params, param_logical_specs,
                                           shard_params)
    from repro_torch.common.tree import tree_map
    from repro_torch.core import collectives
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw_init
    from repro_torch.train import step as TS

    cfg = configs.smoke_config(ARCH)
    schema = TT.model_schema(cfg)
    specs = tree_to_physical(param_logical_specs(schema), mesh)
    params = shard_params(TT.params_from_jax(jp, device="cpu"), schema,
                          mesh)
    out = {"loss_fn": _loss_and_grads(cfg, params, _batch(cfg, 0), mesh)}

    for mb in (1, 2):
        tc = TrainConfig(**train_kw, microbatches=mb)
        # a copy: the step consumes its state, and ``params`` serves on
        mine = tree_map(torch.clone, params)
        state = {"params": mine, "opt": adamw_init(mine, tc),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = TS.make_train_step(cfg, tc, mesh=mesh, param_shardings=specs)
        ms = []
        for i in range(TRAIN_STEPS):
            state, m = step(state, _batch(cfg, 10 + i))
            ms.append({k: float(v) for k, v in m.items()})
        out[f"train_mb{mb}"] = (ms, _full(state["params"], specs, mesh))

    # placements the step refuses before any collective: shardings that
    # are not the rule table's, and a state that is not this rank's blocks
    refused = []
    tc = TrainConfig(**train_kw)
    bad = {**specs, "final_norm": {"w": ("model",)}}
    for shardings, p in ((bad, params), (specs, TT.params_from_jax(
            jp, device="cpu"))):
        state = {"params": p, "opt": adamw_init(p, tc),
                 "step": torch.zeros((), dtype=torch.int32)}
        try:
            TS.make_train_step(cfg, tc, mesh=mesh,
                               param_shardings=shardings)(
                state, _batch(cfg, 10))
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    from repro_torch.core import cgtrans
    try:
        cgtrans.is_sharded(mesh)
        out["graph_refusal"] = None
    except NotImplementedError as e:
        out["graph_refusal"] = str(e)

    prompt = {"tokens": _batch(cfg, 20, s=P)["tokens"]}
    for flash in (False, True):
        FK.reset_launch_counts()
        calls0 = FK.flash_attention_plain.calls
        # the plain prefill keeps the "heads" layout, the flash one the
        # default "seq", whose cache splits its slots over model
        layout = "seq" if flash else "heads"
        pre = TS.make_prefill_step(cfg, cache_len=SEQ_T if flash else
                                   P + GEN + 1, mesh=mesh, use_flash=flash,
                                   cache_layout=layout)
        dec = TS.make_decode_step(cfg, mesh=mesh, cache_layout=layout)
        with torch.no_grad():
            logits, caches = pre(params, prompt)
            seq = [logits.numpy()]
            for i in range(GEN):
                logits, caches = dec(params, torch.from_numpy(
                    forced[:, i:i + 1]), caches, P + i)
                seq.append(logits.numpy())
        out[f"serve_flash{int(flash)}"] = (
            seq, FK.flash_attention_plain.calls - calls0,
            tuple(caches["blocks"]["p0"]["attn"]["k"].shape))

    g3 = configs.smoke_config("gemma3-12b")
    out["gemma3"] = _loss_and_grads(
        g3, init_params(TT.model_schema(g3), 0, device="cpu", mesh=mesh),
        _batch(g3, 0), mesh)
    for arch in SMOKE:
        c = configs.smoke_config(arch)
        sp = tree_to_physical(param_logical_specs(TT.model_schema(c)), mesh)
        tc = TrainConfig(**train_kw)
        state = TS.init_state(c, tc, 0, mesh=mesh)
        with collectives.count_collectives() as counted:
            state, m = TS.make_train_step(c, tc, mesh=mesh)(state,
                                                            _batch(c, 3))
        out[arch] = ({k: float(v) for k, v in m.items()},
                     _full(state["params"], sp, mesh), dict(counted.calls))
    out["modules"] = _foreign_modules()
    return out


SEQ_SERVE = (("qwen24_seq", ARCH, "m24"), ("gemma18_seq", "gemma2-2b",
                                          "m18"))
SEQ_LEN = 16             # the cache: 16 / tp slots per model rank


def _seq_serve(cfg, params, mesh):
    """Prefill of P tokens and GEN decode steps (cache ``"seq"``, the
    default) of a B = 2 batch: the logits of every step."""
    from repro_torch.train import step as TS
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (2, P)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (2, GEN)).astype(np.int32)
    logits, caches = TS.make_prefill_step(cfg, cache_len=SEQ_LEN,
                                          mesh=mesh)(
        params, {"tokens": torch.from_numpy(prompt)})
    dec = TS.make_decode_step(cfg, mesh=mesh)
    seq = [logits.numpy()]
    for i in range(GEN):
        logits, caches = dec(params, torch.from_numpy(forced[:, i:i + 1]),
                             caches, P + i)
        seq.append(logits.numpy())
    return seq


def _block_fn(x, w):
    return torch.tanh(x @ w)


def _eight_rank(dmesh, table, ids, qbatch, ckpt_dir, W, x):
    from repro_torch.analysis import contracts as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.logical import local_block, to_physical
    from repro_torch.common.schema import init_params
    from repro_torch.core import collectives
    from repro_torch.launch.counts import count_run
    from repro_torch.models import transformer as TT
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.train.pipeline import pipelined_apply

    kw = dict(backend=dmesh.backend, device=dmesh.device)
    m24 = meshlib.make_test_mesh(2, 4, **kw)
    m42 = meshlib.make_test_mesh(4, 2, **kw)
    m222 = meshlib.make_mesh((2, 2, 2), **kw)
    m18 = meshlib.make_mesh((1, 8), **kw)
    out = {}

    # -- the lookup on 2 x 4 -----------------------------------------------
    tab = torch.from_numpy(local_block(table, ("model", None), m24).copy())
    mine = torch.from_numpy(local_block(ids, ("data", None), m24).copy())

    def rows_of(e):
        return collectives.all_gather(e, m24, axis="data").reshape(
            -1, *e.shape[1:]).numpy()

    def table_of(g):
        return collectives.all_gather(g, m24, axis="model").reshape(
            -1, g.shape[-1]).numpy()

    out["values"] = rows_of(embed_lookup(tab, mine, mesh=m24,
                                         compute_dtype=torch.float32))
    for impl in ("ref", "kernel"):
        for chunk in (None, 5):
            t = tab.clone().requires_grad_(True)
            e = embed_lookup(t, mine, mesh=m24, compute_dtype=torch.float32,
                             impl=impl, request_chunk=chunk)
            (e * e).sum().backward()
            out[("grad", impl, chunk)] = (rows_of(e.detach()),
                                          table_of(t.grad))
    t = tab.clone().requires_grad_(True)
    run = count_run(lambda a, b: embed_lookup(
        a, b, mesh=m24, cgtrans=False, compute_dtype=torch.float32), t, mine)
    (run.output * run.output).sum().backward()
    out["baseline"] = (rows_of(run.output.detach()), table_of(t.grad),
                       run.calls, run.bytes)
    out["contracts"] = C.verify_rank(
        dmesh, names=[n for n in C.CONTRACTS if n.startswith("embed")])

    # -- qwen with split q heads and replicated kv heads; over pods -------
    cfg = configs.smoke_config(ARCH)
    for name, m in (("qwen24", m24), ("qwen222", m222)):
        out[name] = _loss_and_grads(cfg, init_params(
            TT.model_schema(cfg), 0, device="cpu", mesh=m), qbatch, m)

    # -- "seq" caches where the heads split unevenly ----------------------
    for name, arch, mname in SEQ_SERVE:
        m = {"m24": m24, "m18": m18}[mname]
        c = configs.smoke_config(arch)
        with torch.no_grad():
            out[name] = _seq_serve(c, init_params(
                TT.model_schema(c), 0, device="cpu", mesh=m), m)

    # -- elastic checkpoint ------------------------------------------------
    spec_tree = {"w": ("vocab", "embed"), "b": (None,)}
    state = {"w": torch.arange(64 * 4, dtype=torch.float32).reshape(64, 4),
             "b": torch.ones(4)}
    blocks = {k: local_block(v, to_physical(spec_tree[k], m42),
                             m42).clone() for k, v in state.items()}
    CheckpointManager(ckpt_dir, mesh=m42).save(blocks, 7,
                                               spec_tree=spec_tree)
    got, step = CheckpointManager(ckpt_dir, mesh=m24).restore(
        state, mesh=m24, spec_tree=spec_tree)
    want = local_block(state["w"], to_physical(spec_tree["w"], m24), m24)
    whole, _ = CheckpointManager(ckpt_dir).restore(state)
    out["ckpt"] = (step, tuple(got["w"].shape), bool(torch.equal(
        got["w"], want)), bool(torch.equal(whole["w"], state["w"])),
        bool(torch.equal(got["b"], state["b"])))

    # -- the pipeline over pod ---------------------------------------------
    w = torch.from_numpy(W).requires_grad_(True)
    y = pipelined_apply(_block_fn, w, torch.from_numpy(x), mesh=m222)
    y.sum().backward()
    out["pipeline"] = (y.detach().numpy(), w.grad.numpy(),
                       m222.axis_index("pod"))
    out["modules"] = _foreign_modules()
    return out


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _jax_world():
    """The JAX references of the model spawn: parameters, the loss and
    its gradients, two steps at 1 and 2 microbatches, and the served
    logits with their greedy tokens."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from _lm_parity import TRAIN_KW, jax_params, states
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.train import step as JS

    jcfg = jconfigs.smoke_config(ARCH)
    jp = jax_params(jcfg, S)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg), has_aux=True))(
            jp, _batch(jcfg, 0))
    ref = {"loss_fn": (float(jl), {k: float(v) for k, v in jm.items()},
                       jax.tree.map(np.asarray, jg))}
    for mb in (1, 2):
        jstate, _, jtc, _ = states(jp, **TRAIN_KW)
        jtc = dataclasses.replace(jtc, microbatches=mb)
        step = jax.jit(JS.make_train_step(jcfg, jtc))
        ms = []
        for i in range(TRAIN_STEPS):
            jstate, m = step(jstate, _batch(jcfg, 10 + i))
            ms.append({k: float(v) for k, v in m.items()})
        ref[f"train_mb{mb}"] = (ms, jax.tree.map(np.asarray,
                                                 jstate["params"]))
    prompt = {"tokens": _batch(jcfg, 20, s=P)["tokens"]}
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, jcfg, cache_len=P + GEN + 1))(jp, prompt)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    seq, tokens = [np.asarray(logits)], []
    for i in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, caches = dec(jp, tok, caches, jnp.asarray(P + i, jnp.int32))
        seq.append(np.asarray(logits))
    ref["serve"] = seq
    return jp, TRAIN_KW, np.concatenate(tokens, axis=1), ref


@pytest.fixture(scope="module")
def model():
    jp, train_kw, forced, ref = _jax_world()
    ranks = meshlib.spawn(_model_rank, (2, 2), backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S,
                          args=(jp, train_kw, forced))
    return ranks, ref, train_kw


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 8)).astype(np.int32)
    W = (rng.standard_normal((6, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 2, 5, 8)).astype(np.float32)
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    qbatch = _batch(configs.smoke_config(ARCH), 0)
    ranks = meshlib.spawn(_eight_rank, 8, backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S,
                          args=(table, ids, qbatch, ckpt, W, x))
    return ranks, dict(table=table, ids=ids, W=W, x=x, ckpt=ckpt,
                       qbatch=qbatch)


def _tree_by_path(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_by_path(v, (*prefix, k)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_paths(got, want, **tol):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], err_msg=str(p), **tol)


def _port_loss_and_grads(cfg, batch):
    """The unsharded port's loss, metrics and gradients by path."""
    from repro_torch.common.schema import init_params
    from repro_torch.common.tree import leaves_with_paths, tree_map
    from repro_torch.models import transformer as TT
    live = tree_map(lambda t: t.requires_grad_(True), init_params(
        TT.model_schema(cfg), 0, device="cpu"))
    total, metrics = TT.loss_fn(live, batch, cfg)
    total.backward()
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {p: v.grad.numpy() for p, v in leaves_with_paths(live)})


def _assert_grads_close(got, want, rel=1e-5):
    """Each leaf within ``rel`` of that leaf's max |g| (a key bias's
    gradient is zero up to f32 noise, so no elementwise rtol)."""
    assert set(got) == set(want)
    for p in want:
        scale = max(float(np.abs(want[p]).max()), 1e-6)
        np.testing.assert_allclose(got[p], want[p], rtol=0,
                                   atol=rel * scale, err_msg=str(p))


# ---------------------------------------------------------------------------
# the (data 2 x model 2) mesh: qwen against the JAX package
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax(model, eight):
    assert all(r["modules"] == [] for r in model[0])
    assert all(r["modules"] == [] for r in eight[0])


def test_loss_fn_and_gradients_match_the_reference(model):
    ranks, ref, _ = model
    jl, jm, jg = ref["loss_fn"]
    for r in ranks:
        loss, metrics, grads = r["loss_fn"]
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert metrics["tokens"] == B * S - 3
        _assert_paths(grads, _tree_by_path(jg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_the_reference(model, mb):
    ranks, ref, _ = model
    jms, jparams = ref[f"train_mb{mb}"]
    want = _tree_by_path(jparams)
    for r in ranks:
        ms, params = r[f"train_mb{mb}"]
        for m, jm in zip(ms, jms):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-4,
                                           err_msg=k)
        _assert_paths(params, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flash", [0, 1])
def test_prefill_and_decode_match_the_reference(model, flash):
    """The sharded step builders return the global logits; with
    ``use_flash`` each rank's prefill runs its local heads through the
    flash kernel's plain version (one call per layer)."""
    ranks, ref, _ = model
    cfg = configs.smoke_config(ARCH)
    for r in ranks:
        seq, flash_calls, _ = r[f"serve_flash{flash}"]
        assert len(seq) == len(ref["serve"]) == GEN + 1
        for got, want in zip(seq, ref["serve"]):
            assert got.shape == want.shape == (B, cfg.vocab_padded)
            np.testing.assert_allclose(got[:, :cfg.vocab],
                                       want[:, :cfg.vocab], rtol=1e-4,
                                       atol=2e-4)
        assert flash_calls == (cfg.n_layers if flash else 0)


def test_step_refuses_a_placement_that_is_not_the_rule_tables(model):
    for r in model[0]:
        bad_specs, whole_params = r["refused"]
        assert bad_specs is not None and "param_shardings disagree" in \
            bad_specs and "final_norm" in bad_specs
        assert whole_params is not None and "init_state(mesh=)" in \
            whole_params


def test_graph_dataflows_refuse_the_named_mesh(model):
    """The graph dataflows shard over a ``DataMesh`` only; a named-axis
    ``Mesh`` is refused with a message naming the mesh they take."""
    for r in model[0]:
        msg = r["graph_refusal"]
        assert msg is not None and "DataMesh" in msg and "row 2" in msg


def test_caches_hold_the_rank_rows_and_heads(model):
    """The deliberate divergence of the cache layout: on a mesh each
    rank's cache holds its B/dp rows and Hkv/tp heads; the JAX cache
    schema keeps the heads and shards the sequence over model."""
    cfg = configs.smoke_config(ARCH)
    for r in model[0]:
        shape = r["serve_flash0"][2]
        assert shape == (cfg.n_layers, B // 2, P + GEN + 1,
                         cfg.n_kv_heads // 2, cfg.hd)


def test_flash_prefill_caches_hold_a_sequence_slice(model):
    """The default ``"seq"`` layout (the JAX cache schema): each rank's
    cache holds its B/dp rows, its half of the slots and every kv
    head."""
    cfg = configs.smoke_config(ARCH)
    for r in model[0]:
        assert r["serve_flash1"][2] == (cfg.n_layers, B // 2, SEQ_T // 2,
                                        cfg.n_kv_heads, cfg.hd)


def test_qk_norms_on_split_heads_match_the_unsharded_port(model):
    cfg = configs.smoke_config("gemma3-12b")
    loss, metrics, grads = _port_loss_and_grads(cfg, _batch(cfg, 0))
    for r in model[0]:
        gl, gm, gg = r["gemma3"]
        np.testing.assert_allclose(gl, loss, rtol=1e-5)
        _assert_grads_close(gg, grads)


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_step_matches_the_unsharded_port(model, arch):
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import leaves_with_paths
    from repro_torch.train import step as TS
    cfg = configs.smoke_config(arch)
    tc = TrainConfig(**model[2])
    state, m = TS.make_train_step(cfg, tc)(TS.init_state(cfg, tc, 0,
                                                         device="cpu"),
                                           _batch(cfg, 3))
    want = {p: v.numpy() for p, v in leaves_with_paths(state["params"])}
    for r in model[0]:
        ms, params, calls = r[arch]
        for k in m:
            np.testing.assert_allclose(ms[k], float(m[k]), rtol=1e-4,
                                       err_msg=k)
        _assert_paths(params, want, rtol=1e-5, atol=1e-5)
        # the config's embedding dataflow: the baseline gathers the table
        # over model once, the CGTrans lookup never does
        assert calls.get("table_gather", 0) == (
            0 if cfg.cgtrans_embedding else 1), (arch, calls)


# ---------------------------------------------------------------------------
# 8 ranks: the lookup, the contracts, more meshes, checkpoints, pipeline
# ---------------------------------------------------------------------------

def test_lookup_values_are_the_table_rows(eight):
    ranks, data = eight
    want = data["table"][data["ids"]]
    for r in ranks:
        np.testing.assert_allclose(r["values"], want, atol=1e-6)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("chunk", [None, 5])
def test_lookup_gradient_is_the_dense_and_reference_gradient(eight, impl,
                                                             chunk):
    import jax
    import jax.numpy as jnp
    from repro.models.embedding import embed_lookup as j_embed_lookup
    ranks, data = eight
    table, ids = data["table"], data["ids"]
    dense = np.zeros_like(table)
    np.add.at(dense, ids.reshape(-1), 2 * table[ids.reshape(-1)])
    jg = np.asarray(jax.grad(lambda t: jnp.sum(j_embed_lookup(
        t, jnp.asarray(ids), compute_dtype=jnp.float32) ** 2))(
            jnp.asarray(table)))
    for r in ranks:
        values, grad = r[("grad", impl, chunk)]
        np.testing.assert_allclose(values, table[ids], atol=1e-6)
        np.testing.assert_allclose(grad, dense, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad, jg, rtol=1e-5, atol=1e-5)


def test_baseline_gathers_the_table_as_a_divergence(eight):
    """The JAX baseline's jaxpr holds no collective (GSPMD moves the
    table when it compiles); the port's holds one ``table_gather`` of the
    whole table, and its values and gradient are cgtrans's."""
    from repro_torch.analysis import budgets
    ranks, data = eight
    table, ids = data["table"], data["ids"]
    for r in ranks:
        values, grad, calls, nbytes = r["baseline"]
        np.testing.assert_allclose(values, table[ids], atol=1e-6)
        np.testing.assert_allclose(grad, r[("grad", "ref", None)][1],
                                   rtol=1e-6, atol=1e-6)
        assert {k: v for k, v in calls.items() if v} == \
            budgets.EMBED_FWD["baseline"]
        assert nbytes["table_gather"] == budgets.table_gather_bytes(64, 16)


def test_lookup_contracts_count_clean(eight):
    for r in eight[0]:
        res = r["contracts"]
        assert res["failures"] == {}
        assert set(res["launches"]) == {"embed_lookup/cgtrans/xla",
                                        "embed_lookup/cgtrans/pallas",
                                        "embed_lookup/baseline/xla"}


@pytest.mark.parametrize("name", ["qwen24", "qwen222"])
def test_qwen_on_other_meshes_matches_the_unsharded_port(eight, name):
    """2 × 4: the q heads split over model and the kv heads (2) do not;
    2 × 2 × 2: the batch over pod and data."""
    cfg = configs.smoke_config(ARCH)
    loss, metrics, grads = _port_loss_and_grads(cfg, eight[1]["qbatch"])
    for r in eight[0]:
        gl, gm, gg = r[name]
        np.testing.assert_allclose(gl, loss, rtol=1e-5)
        assert gm["tokens"] == metrics["tokens"]
        _assert_grads_close(gg, grads)


@pytest.mark.parametrize("name,arch", [(n, a) for n, a, _ in SEQ_SERVE])
def test_seq_serving_matches_the_unsharded_port(eight, name, arch):
    """2 × 4: the q heads split over model and the kv heads do not (the
    prefill slices its cache, no relayout); 1 × 8: neither splits, and at
    each decode step six of the eight slices hold no valid position."""
    from repro_torch.common.schema import init_params
    from repro_torch.models import transformer as TT
    cfg = configs.smoke_config(arch)
    with torch.no_grad():
        want = _seq_serve(cfg, init_params(TT.model_schema(cfg), 0,
                                           device="cpu"), None)
    for r in eight[0]:
        for got, w in zip(r[name], want):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)


def test_elastic_checkpoint_and_the_reference_restores_it(eight):
    """Saved on (4, 2), restored on (2, 4): each rank's block of the
    (vocab, embed) leaf is (16, 2); restored whole on one device; and the
    JAX package's manager restores the sharded save."""
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    ranks, data = eight
    for r in ranks:
        step, shape, blocks_ok, whole_ok, b_ok = r["ckpt"]
        assert (step, shape) == (7, (16, 2))
        assert blocks_ok and whole_ok and b_ok
    want = {"w": np.arange(64 * 4, dtype=np.float32).reshape(64, 4),
            "b": np.ones(4, np.float32)}
    got, step = JCheckpointManager(data["ckpt"]).restore(want)
    assert step == 7
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_split_stages_is_the_reference():
    from repro.train.pipeline import split_stages as j_split_stages
    from repro_torch.train.pipeline import split_stages
    assert split_stages(10, 4) == ((0, 3), (3, 6), (6, 8), (8, 10))
    for n, k in [(10, 4), (6, 2), (7, 3), (3, 4)]:
        assert split_stages(n, k) == j_split_stages(n, k)


def test_pipeline_over_pods_is_the_sequential_stack(eight):
    """Values on every pod equal the blocks run in order; the gradient
    summed over the two pods (each holds its stage's part) equals the
    sequential gradient."""
    ranks, data = eight
    w = torch.from_numpy(data["W"]).requires_grad_(True)
    ref = torch.from_numpy(data["x"])
    for i in range(w.shape[0]):
        ref = _block_fn(ref, w[i])
    ref.sum().backward()
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"][0], ref.detach().numpy(),
                                   atol=1e-5)
    by_pod = {}
    for r in ranks:
        by_pod.setdefault(r["pipeline"][2], r["pipeline"][1])
    np.testing.assert_allclose(by_pod[0] + by_pod[1], w.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
