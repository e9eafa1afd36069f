"""Port parity: LM training (``data/pipeline.py``'s token streams,
``models/embedding.py``'s chunked cross-entropy, ``transformer.loss_fn``,
``train/step.py``, the optimiser state's schema, LM checkpoints and
``launch.train --workload lm``) against the JAX package.

The token streams are array-equal; the chunked cross-entropy is held
within 1e-6; ``loss_fn`` and its gradients within 1e-5; three
``make_train_step`` steps of reduced whisper-base, qwen1.5-0.5b and
gemma2-2b within 1e-4 on the losses and 1e-5 on the parameters (at
``_lm_parity.TRAIN_KW``, whose comment says why eps is 1e-3 there), also
with ``microbatches=2`` and ``int8_ef``; remat ``block`` equals ``none``
bit for bit. Parameters are drawn by the JAX package and carried across
(``_lm_parity.jax_params``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import (TRAIN_KW, assert_trees, jax_params, np_tree, shapes,
                        states)
from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.common.config import SHAPES as JSHAPES
from repro.data import ShardedTokenFiles as JShardedTokenFiles
from repro.data import TokenStream as JTokenStream
from repro.models import embedding as JE
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.config import SHAPES, TrainConfig
from repro_torch.common.schema import init_params
from repro_torch.data import ShardedTokenFiles, TokenStream
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import embedding as TE
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

B, S = 2, 16
TRAIN_ARCHS = ["whisper-base", "qwen1.5-0.5b", "gemma2-2b"]


def _stream(cfg, **kw):
    return dict(vocab=cfg.vocab, batch=B, seq_len=S,
                with_frames=cfg.enc_seq if cfg.is_encoder_decoder else 0,
                with_vision=cfg.vision_seq, d_model=cfg.d_model, **kw)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_token_stream_is_array_equal_and_resumes(arch):
    cfg = configs.smoke_config(arch)
    for seed, host in ((0, 0), (3, 1)):
        kw = _stream(cfg, seed=seed, host=host, n_hosts=2)
        want, got = JTokenStream(**kw), TokenStream(**kw)
        it = iter(got)
        for step in range(3):
            b = next(it)
            assert_trees(b, want.batch_at(step))
            assert b["tokens"].dtype == np.int32
        # resume: a restarted stream regenerates step 7 exactly
        assert_trees(got.batch_at(7), want.batch_at(7))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_token_files_cross_between_the_packages(tmp_path, writer):
    tokens = np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32)
    W = JShardedTokenFiles if writer == "jax" else ShardedTokenFiles
    W.write(str(tmp_path), tokens, shard_size=1024)
    assert sorted(os.listdir(tmp_path))[:2] == ["manifest.json",
                                                "shard_00000.npy"]
    for kw in (dict(), dict(start_step=5, host=1, n_hosts=2)):
        want = JShardedTokenFiles(str(tmp_path)).reader(4, 31, **kw)
        got = ShardedTokenFiles(str(tmp_path)).reader(4, 31, **kw)
        for _ in range(6):
            assert_trees(next(got), next(want))


# ---------------------------------------------------------------------------
# the chunked cross-entropy and loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(softcap=30.0, valid_vocab=90),
    dict(byte_budget=4 * 2 * 96 * 5, valid_vocab=90)])   # chunks of 4
def test_chunked_softmax_xent_matches(rng, kw):
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    table = rng.standard_normal((96, 16)).astype(np.float32)
    labels = rng.integers(0, 90, (2, 12)).astype(np.int32)
    labels[0, :5] = -1                                   # padding
    jl, jc = JE.chunked_softmax_xent(x, table, labels, **kw)
    tl, tc = TE.chunked_softmax_xent(torch.from_numpy(x),
                                     torch.from_numpy(table),
                                     torch.from_numpy(labels), **kw)
    assert float(tc) == float(jc) == 19.0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    # the gradient through the checkpointed chunks
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    TE.chunked_softmax_xent(xt, tt, torch.from_numpy(labels),
                            **kw)[0].backward()
    jgx, jgt = jax.grad(lambda a, b: JE.chunked_softmax_xent(
        a, b, labels, **kw)[0], argnums=(0, 1))(x, table)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), jgt, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_fn_and_gradients_match(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jp = jax_params(jcfg, S)
    batch = JTokenStream(**_stream(jcfg)).batch_at(0)
    batch["labels"][0, :3] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg), has_aux=True))(jp, batch)
    live = jax.tree.map(lambda t: t.requires_grad_(True),
                        TT.params_from_jax(jp, device="cpu"))
    tl, tm = TT.loss_fn(live, batch, tcfg)
    tl.backward()
    assert set(tm) == set(jm) == {"loss", "aux_loss", "tokens"}
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S - 3
    assert_trees(jax.tree.map(lambda t: t.grad, live), jg, rtol=1e-5,
                 atol=1e-5)


# ---------------------------------------------------------------------------
# make_train_step against the JAX step
# ---------------------------------------------------------------------------

def _steps(arch, n, **kw):
    """``n`` steps of both packages from the same parameters and batches;
    every step's losses and metrics compared. Returns the final states."""
    jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jstate, tstate, jtc, ttc = states(jax_params(jcfg, S),
                                      **{**TRAIN_KW, **kw})
    jstep = jax.jit(JS.make_train_step(jcfg, jtc))
    tstep = TS.make_train_step(tcfg, ttc)
    stream = JTokenStream(**_stream(jcfg))
    for i in range(n):
        jstate, jm = jstep(jstate, stream.batch_at(i))
        tstate, tm = tstep(tstate, stream.batch_at(i))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        assert not any(p.requires_grad
                       for p in jax.tree.leaves(tstate["params"]))
        assert int(tstate["step"]) == i + 1
    return jstate, tstate


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_three_steps(arch):
    jstate, tstate = _steps(arch, 3)
    assert_trees(tstate["params"], jstate["params"], rtol=1e-5, atol=1e-5)
    assert_trees(tstate["opt"], jstate["opt"], rtol=1e-4, atol=1e-6)


def test_train_step_microbatches_match():
    jstate, tstate = _steps("qwen1.5-0.5b", 2, microbatches=2)
    assert_trees(tstate["params"], jstate["params"], rtol=1e-5, atol=1e-5)


def test_train_step_int8_ef_matches_outside_rounding_flips():
    """int8_ef rounds each gradient element to a multiple of its leaf's
    quantum (max|g| / 127): an element within the gradients' f32 noise of
    a rounding boundary goes to the neighbouring multiple in one package
    and not in the other. Such flips show as a quantum's jump in the
    carried residual; they are counted (a few per thousand) and every
    other element is held to 1e-5."""
    jstate, tstate = _steps("qwen1.5-0.5b", 1, grad_compression="int8_ef")
    assert set(tstate["opt"]) == {"m", "v", "count", "ef_residual"}
    got, want = np_tree(tstate), np_tree(jstate)
    flips = total = 0

    def walk(g, w, rg, rw):
        nonlocal flips, total
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], rg[k], rw[k])
            return
        quantum = 2 * np.abs(rw).max()
        flip = np.abs(rg - rw) > quantum / 4
        flips += int(flip.sum())
        total += flip.size
        np.testing.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)
    walk(got["params"], want["params"], got["opt"]["ef_residual"],
         want["opt"]["ef_residual"])
    assert flips <= 2e-3 * total, (flips, total)


def test_remat_block_equals_none_bit_for_bit():
    base = configs.smoke_config("gemma2-2b")
    assert TT.stack_layout(base).n_blocks == 2
    params = init_params(TT.model_schema(base), 0, device="cpu")
    batch = TokenStream(**_stream(base)).batch_at(0)
    out = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(base, remat=remat)
        live = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                            params)
        loss, _ = TT.loss_fn(live, batch, cfg)
        loss.backward()
        out[remat] = (loss.detach(), jax.tree.map(lambda t: t.grad, live))
    assert torch.equal(out["none"][0], out["block"][0])
    assert_trees(out["block"][1], out["none"][1])


def test_stacked_leaves_get_one_gradient_per_leaf():
    """Each stacked leaf is split once per forward: its gradient is one
    stack of the blocks' gradients, not a zero-filled leaf per block."""
    cfg = configs.smoke_config("qwen1.5-0.5b")
    params = init_params(TT.model_schema(cfg), 0, device="cpu")
    wq = params["stack"]["blocks"]["p0"]["attn"]["wq"].requires_grad_(True)
    loss, _ = TT.loss_fn(params, TokenStream(**_stream(cfg)).batch_at(0),
                         cfg)
    readers = []            # the graph nodes that read the leaf itself
    seen = set()

    def walk(fn):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if getattr(nxt, "variable", None) is wq:
                readers.append(type(fn).__name__)
            walk(nxt)
    walk(loss.grad_fn)
    assert readers == ["UnbindBackward0"], readers
    loss.backward()
    assert wq.grad.shape == wq.shape
    assert all(bool(g.ne(0).any()) for g in wq.grad)


def test_train_step_refuses_a_mesh_and_the_flash_route():
    """A mesh that is not the port's ``Mesh`` raises a ``TypeError``
    naming it (the sharded step: ``tests/test_torch_sharded_lm.py``), as
    do shardings without a mesh; the flash route has no VJP."""
    cfg = configs.smoke_config("whisper-base")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        TS.make_train_step(cfg, TrainConfig(), mesh=object())
    with pytest.raises(ValueError, match="without a mesh"):
        TS.make_train_step(cfg, TrainConfig(), param_shardings={})
    with pytest.raises(NotImplementedError, match="no VJP"):
        TS.make_train_step(cfg, TrainConfig(), use_flash=True)


def test_flash_refuses_gradients_before_any_launch(rng):
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32))
    FK.reset_launch_counts()
    for grads in ((True, False, False), (False, True, False),
                  (False, False, True)):
        args = [t.clone().requires_grad_(g) for t, g in zip((q, k, k),
                                                           grads)]
        with pytest.raises(NotImplementedError, match="no VJP"):
            flash_ops.flash_attention(*args)
    assert FK.flash_attention_plain.calls == 0
    # serving under no_grad and detached inputs still run
    with torch.no_grad():
        flash_ops.flash_attention(q.requires_grad_(True), k, k)
    flash_ops.flash_attention(q.detach(), k, k)
    assert FK.flash_attention_plain.calls == 2


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,compression", [
    ("qwen1.5-0.5b", "none"), ("mamba2-780m", "int8_ef"),
    ("deepseek-moe-16b", "none")])
def test_state_schemas_match(arch, compression):
    from repro.common.config import TrainConfig as JTrainConfig
    from repro.optim import opt_state_schema as j_opt_schema
    from repro_torch.optim import opt_state_schema
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jtc = JTrainConfig(grad_compression=compression)
    ttc = TrainConfig(grad_compression=compression)
    js = JS.state_schema(jcfg, jtc, max_seq=64)
    ts = TS.state_schema(tcfg, ttc, max_seq=64)
    assert shapes(ts) == shapes(js)
    assert shapes(opt_state_schema(ts["params"], ttc)) == \
        shapes(j_opt_schema(js["params"], jtc))
    meta = TS.batch_structs(tcfg, SHAPES["train_4k"])
    assert all(t.device.type == "meta" for t in meta.values())
    assert shapes(meta) == shapes(JS.batch_structs(jcfg, JSHAPES["train_4k"]))


def test_shape_presets_match():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert SHAPES["train_4k"].tokens == JSHAPES["train_4k"].tokens


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_lm_checkpoints_cross_between_the_packages(tmp_path):
    jstate, tstate = _steps("gemma2-2b", 1, grad_compression="int8_ef")
    JCheckpointManager(str(tmp_path / "j")).save(jstate, 1)
    got, step = CheckpointManager(str(tmp_path / "j")).restore(
        jax.tree.map(torch.zeros_like, tstate))
    assert step == 1
    assert_trees(got, np_tree(jstate))
    CheckpointManager(str(tmp_path / "t")).save(tstate, 3)
    back, step = JCheckpointManager(str(tmp_path / "t")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 3
    assert_trees(tstate, np_tree(back))
    with open(tmp_path / "t" / "step_3" / "manifest.json") as f:
        tm = f.read()
    with open(tmp_path / "j" / "step_1" / "manifest.json") as f:
        jm = f.read()
    assert tm == jm.replace('"step": 1', '"step": 3')


def test_launch_train_lm_runs_and_resumes_on_the_cpu(tmp_path, capsys,
                                                     monkeypatch):
    argv = ["--workload", "lm", "--arch", "recurrentgemma-2b", "--reduced",
            "--device", "cpu", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(argv + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "recurrentgemma-2b:" in out and "finished at step 3" in out
    assert CheckpointManager(str(tmp_path)).steps() == [3]
    assert launch_train.main(argv + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at step 3" in out
    assert "finished at step 5" in out
    # the dry run of a production cell, on the one mesh or on two pods
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    for flag, mesh in (("--dry-run", "pod16x16"),
                       ("--multi-pod", "pod2x16x16")):
        assert launch_train.main(["--workload", "lm", "--arch",
                                  "qwen1.5-0.5b", "--shape", "decode_32k",
                                  flag]) == 0
        out = capsys.readouterr().out
        assert f'"mesh": "{mesh}"' in out and '"ok": true' in out
