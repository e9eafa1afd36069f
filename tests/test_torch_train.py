"""Port parity: the training stack (``optim/``, ``train/``, ``checkpoint/``,
``runtime/``, ``launch/train.py``).

AdamW matches the JAX package's arithmetic within 1e-6 (with clipping,
warmup, cosine decay and int8 error feedback); three ``make_sage_train_step``
steps match the JAX step (losses within 1e-4, parameters within 1e-5, as
``tests/test_cgtrans_grad.py`` holds pallas against xla) on both GAS
backends; checkpoints cross between the packages leaf for leaf; the loop
resumes, retains and stops on preemption as the reference does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.common.config import TrainConfig as JTrainConfig
from repro.common.schema import init_params as j_init_params
from repro.core.gcn import GCNConfig as JGCNConfig
from repro.core.gcn import gcn_schema as j_gcn_schema
from repro.data import GraphBatchStream as JGraphBatchStream
from repro.data import synthetic_node_labels as j_labels
from repro.graph import partition_by_src, uniform_graph
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_lr as j_cosine_lr
from repro.train import make_sage_train_step as j_make_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.config import TrainConfig
from repro_torch.core import gcn
from repro_torch.optim import adamw_init, adamw_update, cosine_lr
from repro_torch.runtime import PreemptionGuard
from repro_torch.train import make_sage_train_step, state_from_jax, train_loop

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return (tree.detach().numpy() if torch.is_tensor(tree)
            else np.asarray(tree))


def _assert_trees(got, want, **tol):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees(got[k], want[k], **tol)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_train_config_is_the_reference_s():
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JTrainConfig)]


def test_cosine_lr_matches_reference():
    kw = dict(learning_rate=3e-3, warmup_steps=20, total_steps=300,
              min_lr_ratio=0.1)
    steps = np.arange(0, 320, 7, dtype=np.int32)
    want = np.asarray(j_cosine_lr(jnp.asarray(steps), JTrainConfig(**kw)))
    got = cosine_lr(torch.from_numpy(steps), TrainConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_adamw_matches_reference(compression):
    """Five steps with clipping active (gradient norms ≫ 1), two warmup
    steps and the cosine decay after them."""
    rng = np.random.default_rng([len(compression)])
    shapes = {"w0": (6, 5), "b0": (5,), "head": {"w": (5, 3), "b": (3,)}}
    params = {k: (rng.standard_normal(s).astype(np.float32)
                  if isinstance(s, tuple) else
                  {j: rng.standard_normal(t).astype(np.float32)
                   for j, t in s.items()}) for k, s in shapes.items()}
    grads = [jax.tree.map(lambda p: (4 * rng.standard_normal(p.shape)
                                     ).astype(np.float32), params)
             for _ in range(5)]
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5,
              weight_decay=0.05, grad_compression=compression)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_adamw_init(jp, jtc)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = adamw_init(tp, ttc)
    for g in grads:
        jp, js, jm = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jtc)
        tp, ts, tm = adamw_update(tp, jax.tree.map(torch.from_numpy, g), ts,
                                  ttc)
        assert float(tm["grad_norm"]) > ttc.grad_clip
        _assert_trees(tp, jp, rtol=1e-6, atol=1e-6)
        _assert_trees(ts, js, rtol=1e-6, atol=1e-6)
        _assert_trees(tm, jm, rtol=1e-6, atol=1e-6)
    assert int(ts["count"]) == 5 and ts["count"].dtype == torch.int32


# ---------------------------------------------------------------------------
# make_sage_train_step against the JAX step
# ---------------------------------------------------------------------------

def _graph_world():
    """``test_sage_train_step_pallas_three_steps``'s graph and batch."""
    g = uniform_graph(64, 512, seed=0, n_features=8)
    labels = j_labels(g.features, 4)
    pg = partition_by_src(g, 2)
    stream = JGraphBatchStream(g, labels, n_parts=2, batch_per_part=8,
                               k1=3, k2=3)
    return pg.features, stream.batch_at(0)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_sage_train_step_matches_reference_three_steps(impl):
    feats, batch = _graph_world()
    jimpl = {"kernel": "pallas", "ref": "xla"}[impl]
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=3,
              weight_decay=0.0)
    jcfg = JGCNConfig(n_features=8, hidden=16, n_classes=4, fanout=3,
                      impl=jimpl)
    tcfg = gcn.GCNConfig(n_features=8, hidden=16, n_classes=4, fanout=3,
                         impl=impl)
    jparams = j_init_params(j_gcn_schema(jcfg), jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": j_adamw_init(jparams,
                                                     JTrainConfig(**kw)),
              "step": jnp.zeros((), jnp.int32)}
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(j_make_step(jcfg, JTrainConfig(**kw),
                                feats=jnp.asarray(feats)))
    tstep = make_sage_train_step(tcfg, TrainConfig(**kw),
                                 feats=torch.from_numpy(feats))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, batch)
        losses.append(float(tm["total_loss"]))
        assert set(tm) == set(jm) == {"loss", "acc", "grad_norm", "lr",
                                      "total_loss"}
        np.testing.assert_allclose(losses[-1], float(jm["total_loss"]),
                                   rtol=1e-4, atol=1e-4)
        _assert_trees(tstate["params"], jstate["params"], rtol=1e-5,
                      atol=1e-5)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert not any(p.requires_grad for p in tstate["params"].values())
    assert losses[-1] < losses[0], losses


def test_sage_train_step_refuses_unported_knobs():
    tcfg = gcn.GCNConfig(n_features=8, hidden=16, n_classes=4)
    feats = torch.zeros(1, 8, 8)
    with pytest.raises(NotImplementedError, match="row 2"):
        make_sage_train_step(tcfg, TrainConfig(), feats=feats, mesh=object())
    # the JAX rule: a relabel map needs partition="island"
    with pytest.raises(ValueError, match="requires partition='island'"):
        make_sage_train_step(tcfg, TrainConfig(), feats=feats,
                             relabel=np.arange(8))


# ---------------------------------------------------------------------------
# the loop and checkpoints
# ---------------------------------------------------------------------------

def _tiny_run():
    """A CPU step function, a fresh state and a stateless batch stream."""
    feats, _ = _graph_world()
    g = uniform_graph(64, 512, seed=0, n_features=8)
    stream = JGraphBatchStream(g, j_labels(g.features, 4), n_parts=2,
                               batch_per_part=4, k1=3, k2=3)
    cfg = gcn.GCNConfig(n_features=8, hidden=16, n_classes=4, fanout=3)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=7)
    from repro_torch.common.schema import init_params
    params = init_params(gcn.gcn_schema(cfg), 0, device="cpu")
    state = {"params": params, "opt": adamw_init(params, tc),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_sage_train_step(cfg, tc, feats=torch.from_numpy(feats))
    return step, state, stream


def _fresh(state):
    """A copy of ``state``: the step consumes the state it is given."""
    from repro_torch.common.tree import tree_map
    return tree_map(torch.clone, state)


def test_train_loop_resumes_bit_exact_and_keeps_the_newest(tmp_path):
    step, state0, stream = _tiny_run()
    want, n = train_loop(step_fn=step, state=_fresh(state0),
                         batches=iter(stream), total_steps=7,
                         log_fn=lambda s: None)
    assert n == 7
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    _, n = train_loop(step_fn=step, state=_fresh(state0),
                      batches=iter(stream), total_steps=5, ckpt=ckpt,
                      ckpt_every=2, log_fn=lambda s: None)
    assert n == 5 and ckpt.steps() == [4, 5]
    logs = []
    got, n = train_loop(step_fn=step, state=_fresh(state0),
                        batches=iter(stream),
                        total_steps=7, ckpt=ckpt, ckpt_every=2,
                        log_fn=logs.append)
    assert n == 7 and "[resume] restored checkpoint at step 5" in logs
    assert ckpt.steps() == [6, 7]
    _assert_trees(got, want)


def test_train_loop_checkpoints_and_stops_on_preemption(tmp_path):
    step, state0, stream = _tiny_run()
    guard = PreemptionGuard(install=False)

    def preempted_after_two(state, batch):
        out = step(state, batch)
        if int(out[0]["step"]) == 2:
            guard.trigger()
        return out

    ckpt = CheckpointManager(str(tmp_path), keep=3)
    logs = []
    state, n = train_loop(step_fn=preempted_after_two, state=_fresh(state0),
                          batches=iter(stream), total_steps=7, ckpt=ckpt,
                          ckpt_every=100, guard=guard, log_fn=logs.append)
    assert n == 2 and ckpt.steps() == [2]
    assert any(s.startswith("[preempt]") for s in logs)
    restored, at = ckpt.restore(state0)
    assert at == 2
    _assert_trees(restored, state)


def _jax_state():
    jcfg = JGCNConfig(n_features=8, hidden=16, n_classes=4)
    tc = JTrainConfig(grad_compression="int8_ef")
    p = j_init_params(j_gcn_schema(jcfg), jax.random.PRNGKey(3))
    opt = j_adamw_init(p, tc)
    opt = jax.tree.map(lambda x: x + 0.5 if x.dtype == jnp.float32 else x + 4,
                       opt)
    return {"params": p, "opt": opt, "step": jnp.asarray(4, jnp.int32)}


def test_checkpoints_cross_between_the_packages(tmp_path):
    jstate = _jax_state()
    JCheckpointManager(str(tmp_path / "j")).save(jstate, 4)
    template = state_from_jax(jax.tree.map(lambda x: np.zeros_like(x),
                                           jstate), device="cpu")
    got, step = CheckpointManager(str(tmp_path / "j")).restore(template)
    assert step == 4
    _assert_trees(got, jax.tree.map(np.asarray, jstate))

    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    CheckpointManager(str(tmp_path / "t")).save(tstate, 9)
    back, step = JCheckpointManager(str(tmp_path / "t")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 9
    _assert_trees(tstate, jax.tree.map(np.asarray, back))
    with open(tmp_path / "t" / "step_9" / "manifest.json") as f:
        tm = f.read()
    with open(tmp_path / "j" / "step_4" / "manifest.json") as f:
        jm = f.read()
    assert tm == jm.replace('"step": 4', '"step": 9')


def test_restore_places_leaves_and_refuses_a_mesh(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save({"a": torch.arange(3), "b": {"c": torch.ones(2)}}, 1)
    got, _ = ckpt.restore({"a": np.zeros(3), "b": {"c": np.zeros(2)}},
                          device="cpu")
    assert got["a"].tolist() == [0, 1, 2]
    assert got["b"]["c"].device.type == "cpu"
    with pytest.raises(ValueError, match="device="):
        ckpt.restore({"a": np.zeros(3), "b": {"c": np.zeros(2)}})
    # sharded placement takes the port's Mesh and the logical specs
    # together (elastic restore: tests/test_torch_sharded_lm.py)
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        ckpt.restore({"a": torch.zeros(3), "b": {"c": torch.zeros(2)}},
                     mesh=object(), spec_tree={"a": (None,),
                                               "b": {"c": (None,)}})
    with pytest.raises(ValueError, match="together"):
        ckpt.restore({"a": torch.zeros(3), "b": {"c": torch.zeros(2)}},
                     mesh=object())


# ---------------------------------------------------------------------------
# the launcher, and inference staying gradient-free
# ---------------------------------------------------------------------------

def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--workload",
         "graph", "--device", "cpu", "--steps", "3", "--scale", "8",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "done at step 3: eval loss" in res.stdout
    assert CheckpointManager(str(tmp_path)).steps() == [3]


def test_launch_train_defaults_to_the_card_and_refuses_lm():
    """Both workloads default to the card; ``--workload lm`` trains (here
    on the CPU, reduced) where it used to raise."""
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--steps", "1", "--scale", "6"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--workload", "lm", "--arch", "qwen1.5-0.5b",
                        "--reduced", "--steps", "1"])
    assert train.main(["--workload", "lm", "--arch", "qwen1.5-0.5b",
                       "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq-len", "8"]) == 0


def test_inference_outputs_do_not_require_grad():
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.common.schema import init_params

    cfg = configs.smoke_config("qwen1.5-0.5b")
    params = init_params(T.model_schema(cfg, max_seq=12), 0, device="cpu")
    for p in jax.tree.leaves(params):
        p.requires_grad_(True)
    out = serve.generate(params, serve.lm_batch(cfg, 2, 8), cfg, gen=3,
                         use_flash=False)
    assert not any(lg.requires_grad for lg in out["logits"])

    feats, batch = _graph_world()
    cfg = gcn.GCNConfig(n_features=8, hidden=16, n_classes=4, fanout=3,
                        impl="kernel")
    from repro_torch.common.schema import init_params as t_init
    tp = {k: v.requires_grad_(True) for k, v in
          t_init(gcn.gcn_schema(cfg), 0, device="cpu").items()}
    f = torch.from_numpy(feats).requires_grad_(True)
    assert gcn.sage_forward(tp, f, batch, cfg).requires_grad
    with torch.no_grad():
        assert not gcn.sage_forward(tp, f, batch, cfg).requires_grad
