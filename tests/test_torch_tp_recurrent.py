"""Port parity: the tensor-parallel recurrent mixers (``ssm.ssd_*`` for
mamba2-780m, ``griffin.rglru_*`` for recurrentgemma-2b) on gloo ranks.

One spawn of 4 ranks as a (data 2 × model 2) mesh runs reduced
mamba2-780m (8 heads) and reduced recurrentgemma-2b (width 64) on
parameters drawn by the JAX package (``_lm_parity.jax_params``):

* ``loss_fn`` and its gradients within 1e-5 of the JAX package's
  unsharded ``loss_fn``;
* a prefill of 8 tokens and 4 decode steps within rtol 1e-4, atol 2e-4
  of JAX's greedy run; each rank's caches hold its rows, H/2 heads of the
  SSD state and W/2 channels of the RG-LRU state and convs (the JAX cache
  schema's specs), and equal its block (``shard_params``) of JAX's
  prefill caches;
* one mixer's forward, counted by name: two ``psum`` over ``model``, of
  the bytes and dtype of the two all-reduces in the JAX program GSPMD
  lowers for the same mixer (a subprocess on fake devices: SSD an f32
  (B, S) and an f32 (B, S, D); RG-LRU the tuple of two f32 (B, S, W) gate
  partials and an f32 (B, S, D)); the ZeRO-3 gathers, counted apart, carry
  only the ``embed`` dimension over ``data`` of the rank's heads or
  channels (no ``model`` gather of a split leaf);
* the train step refusing a placement of a recurrent leaf that is not
  the rule table's.

A ``model`` axis that does not divide the heads cannot hold the leaves:
the port's ``shard_params`` refuses the placement, as JAX's
``device_put`` does (the same subprocess), so there is no replicated
mixer to fall back to on a mesh.

The ranks import ``torch`` and ``repro_torch`` only.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from test_torch_sharded_lm import (_assert_paths, _batch, _foreign_modules,
                                   _loss_and_grads, _tree_by_path)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
ARCHS = ("mamba2-780m", "recurrentgemma-2b")
MIXER = {"mamba2-780m": "ssd", "recurrentgemma-2b": "rglru"}
B, S = 4, 8              # the global batch: 2 rows per data rank
P, GEN = 8, 4            # prompt and decode steps
CACHE_T = P + GEN        # even: a local layer's "seq" cache splits
ROWS = B // 2            # one data rank's rows


def _first_layer(stack):
    """The first layer of a stack tree (params, caches or specs):
    ``prefix_0``, or pattern position ``p0`` of the blocks (stacked)."""
    return stack["prefix_0"] if "prefix_0" in stack else \
        stack["blocks"]["p0"]


def _first_mixer(stack):
    """The first recurrent layer's ``mixer`` entry (block 0 where the
    layers are stacked)."""
    mixer = _first_layer(stack)["mixer"]
    return mixer if "prefix_0" in stack else \
        {k: v[0] for k, v in mixer.items()}


def _mixer_x(cfg):
    rng = np.random.default_rng(9)
    return rng.standard_normal((ROWS, S, cfg.d_model)).astype(np.float32)


def _rank(mesh, worlds):
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.logical import tree_to_physical
    from repro_torch.common.schema import param_logical_specs, shard_params
    from repro_torch.common.tree import leaves_with_paths
    from repro_torch.core import collectives
    from repro_torch.models import griffin, ssm
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw_init
    from repro_torch.train import step as TS

    out = {}
    for arch, (jp, jcaches, forced) in worlds.items():
        cfg = configs.smoke_config(arch)
        schema = TT.model_schema(cfg)
        params = shard_params(TT.params_from_jax(jp, device="cpu"), schema,
                              mesh)
        res = {"loss_fn": _loss_and_grads(cfg, params, _batch(cfg, 0), mesh)}

        prompt = _batch(cfg, 20, s=P)["tokens"]
        pre = TS.make_prefill_step(cfg, cache_len=CACHE_T, mesh=mesh)
        dec = TS.make_decode_step(cfg, mesh=mesh)
        with torch.no_grad():
            logits, caches = pre(params, {"tokens": prompt})
            want = shard_params(TT.params_from_jax(jcaches, device="cpu"),
                                TT.stack_cache_schema_for(cfg, B, CACHE_T),
                                mesh)
            got = dict(leaves_with_paths(caches))
            res["jax_caches"] = {
                p: (tuple(got[p].shape), tuple(w.shape),
                    float((got[p].float() - w.float()).abs().max()))
                for p, w in leaves_with_paths(want)}
            res["cache_shapes"] = {k: tuple(v.shape) for k, v in
                                   _first_mixer(caches).items()}
            seq = [logits.numpy()]
            for i in range(GEN):
                logits, caches = dec(params, torch.from_numpy(
                    forced[:, i:i + 1]), caches, P + i)
                seq.append(logits.numpy())
        res["serve"] = seq

        # one mixer's forward on the rank's rows, counted
        apply = ssm.ssd_apply if MIXER[arch] == "ssd" else griffin.rglru_apply
        layer = _first_mixer(params["stack"])
        with torch.no_grad(), collectives.count_collectives() as counted:
            apply(layer, torch.from_numpy(_mixer_x(cfg)), cfg, mesh=mesh)
        res["mixer"] = (dict(counted.calls), dict(counted.bytes),
                        {k: sorted(v) for k, v in counted.dtypes.items()})

        # a recurrent leaf placed off the rule table is refused
        bad = copy.deepcopy(tree_to_physical(param_logical_specs(schema),
                                             mesh))
        mixer = _first_layer(bad["stack"])["mixer"]
        leaf = "out_proj" if MIXER[arch] == "ssd" else "w_out"
        mixer[leaf] = (None,) * len(mixer[leaf])
        tc = TrainConfig()
        state = {"params": params, "opt": adamw_init(params, tc),
                 "step": torch.zeros((), dtype=torch.int32)}
        try:
            TS.make_train_step(cfg, tc, mesh=mesh, param_shardings=bad)(
                state, _batch(cfg, 10))
            res["refused"] = None
        except ValueError as e:
            res["refused"] = str(e)
        out[arch] = res
    out["modules"] = _foreign_modules()
    return out


def _jax_world(arch):
    """(JAX parameters, JAX prefill caches, JAX greedy tokens, reference):
    the unsharded loss and gradients, and the served logits."""
    import jax
    import jax.numpy as jnp
    from _lm_parity import jax_params
    from repro import configs as jconfigs
    from repro.models import transformer as JT

    jcfg = jconfigs.smoke_config(arch)
    jp = jax_params(jcfg, S)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg), has_aux=True))(
            jp, _batch(jcfg, 0))
    ref = {"loss_fn": (float(jl), {k: float(v) for k, v in jm.items()},
                       jax.tree.map(np.asarray, jg))}
    prompt = {"tokens": _batch(jcfg, 20, s=P)["tokens"]}
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, jcfg, cache_len=CACHE_T))(jp, prompt)
    jcaches = jax.tree.map(np.asarray, caches)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg))
    seq, tokens = [np.asarray(logits)], []
    for i in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, caches = dec(jp, tok, caches, jnp.asarray(P + i, jnp.int32))
        seq.append(np.asarray(logits))
    ref["serve"] = seq
    return jp, jcaches, np.concatenate(tokens, axis=1), ref


@pytest.fixture(scope="module")
def world():
    refs, worlds = {}, {}
    for arch in ARCHS:
        jp, jcaches, forced, refs[arch] = _jax_world(arch)
        worlds[arch] = (jp, jcaches, forced)
    ranks = meshlib.spawn(_rank, (2, 2), backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S, args=(worlds,))
    return ranks, refs


# ---------------------------------------------------------------------------
# the JAX program of one mixer on fake devices
# ---------------------------------------------------------------------------

_PROBE = r"""
import json, re
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.common.logical import to_physical
from repro.common.schema import init_params, param_logical_specs
from repro.models import griffin, ssm
BYTES = {"f32": 4, "bf16": 2}
def place(schema, mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, to_physical(s, mesh)),
                        param_logical_specs(schema),
                        is_leaf=lambda x: isinstance(x, tuple))
ROWS, S = DIMS
out = {}
# the model axis of the port's ranks, its data axis 1: a rank's rows
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
for kind, arch, schema_fn, fn in (
        ("ssd", "mamba2-780m", ssm.ssd_schema, ssm.ssd_apply),
        ("rglru", "recurrentgemma-2b", griffin.rglru_schema,
         griffin.rglru_apply)):
    cfg = configs.smoke_config(arch)
    schema = schema_fn(cfg)
    p = jax.device_put(init_params(schema, jax.random.PRNGKey(0)),
                       place(schema, mesh))
    x = jnp.ones((ROWS, S, cfg.d_model), jnp.float32)
    txt = jax.jit(lambda p, x, c=cfg, f=fn: f(p, x, c)).lower(
        p, x).compile().as_text()
    reduces = []
    for line in txt.splitlines():
        if not re.search(r"\ball-reduce(-start)?\(", line):
            continue
        result = line.split("=", 1)[1].split(" all-reduce")[0]
        shapes = re.findall(r"(f32|bf16)\[([0-9,]*)\]", result)
        reduces.append([[dt, [int(d) for d in dims.split(",") if d]]
                        for dt, dims in shapes])
    out[kind] = {"all_reduce": reduces, "other": sorted(set(re.findall(
        r"\b(all-gather|reduce-scatter|all-to-all|collective-permute)"
        r"(?:-start)?\(", txt)))}
# a model axis of 3 does not divide the 8 heads of reduced mamba2-780m
mesh3 = Mesh(np.array(jax.devices()[:3]).reshape(1, 3), ("data", "model"))
schema = ssm.ssd_schema(configs.smoke_config("mamba2-780m"))
try:
    jax.device_put(init_params(schema, jax.random.PRNGKey(0)),
                   place(schema, mesh3))
    out["model3"] = None
except ValueError as e:
    out["model3"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_program():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = _PROBE.replace("DIMS", repr((ROWS, S)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax(world):
    assert all(r["modules"] == [] for r in world[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match_the_reference(world, arch):
    ranks, refs = world
    jl, jm, jg = refs[arch]["loss_fn"]
    for r in ranks:
        loss, metrics, grads = r[arch]["loss_fn"]
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        for k in jm:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        _assert_paths(grads, _tree_by_path(jg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(world, arch):
    ranks, refs = world
    cfg = configs.smoke_config(arch)
    for r in ranks:
        seq = r[arch]["serve"]
        assert len(seq) == len(refs[arch]["serve"]) == GEN + 1
        for got, want in zip(seq, refs[arch]["serve"]):
            assert got.shape == want.shape == (B, cfg.vocab_padded)
            np.testing.assert_allclose(got[:, :cfg.vocab],
                                       want[:, :cfg.vocab], rtol=1e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_hold_the_rank_heads_and_channels(world, arch):
    """The JAX cache schema's specs: the rank's rows, H/2 heads of the SSD
    state and W/2 channels of ``conv_x``, ``h`` and ``conv``; the SSD's
    ``conv_b`` and ``conv_c`` whole."""
    from repro_torch.models import ssm
    cfg = configs.smoke_config(arch)
    K = cfg.conv_kernel
    if MIXER[arch] == "ssd":
        d_inner, H, P_, N = ssm.dims(cfg)
        want = {"state": (ROWS, H // 2, P_, N),
                "conv_x": (ROWS, K - 1, d_inner // 2),
                "conv_b": (ROWS, K - 1, N), "conv_c": (ROWS, K - 1, N)}
    else:
        W = cfg.lru_width
        want = {"h": (ROWS, W // 2), "conv": (ROWS, K - 1, W // 2)}
    for r in world[0]:
        assert r[arch]["cache_shapes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_are_the_rank_block_of_the_jax_caches(world, arch):
    """``shard_params`` of JAX's unsharded prefill caches under the port's
    cache schema gives each rank the block its own prefill built (the
    attention caches of recurrentgemma's local layers in the ``"seq"``
    layout too)."""
    for r in world[0]:
        cmp = r[arch]["jax_caches"]
        assert cmp
        for path, (got, want, diff) in cmp.items():
            assert got == want, path
            assert diff <= 2e-5, (path, diff)


def _jax_reduces(probe):
    """(calls, bytes, dtypes) of the JAX program's all-reduces."""
    sizes = [[4 * int(np.prod(dims)) for dt, dims in op]
             for op in probe["all_reduce"]]
    dtypes = sorted({dt for op in probe["all_reduce"] for dt, _ in op})
    return len(sizes), sum(map(sum, sizes)), dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_collectives_equal_the_jax_program(world, jax_program, arch):
    """One forward of the mixer: the port's psums over ``model`` equal the
    JAX program's all-reduces in number, bytes and dtype (SSD: (B, S) and
    (B, S, D); RG-LRU: the two (B, S, W) gate partials in one, and (B, S,
    D)); the program holds no other collective; the port's ZeRO-3
    gathers (counted apart) move the rank's ``model`` block of each
    ``embed`` leaf, gathered over ``data`` only."""
    from repro_torch.common.logical import local_shape, to_physical
    from repro_torch.common.schema import leaves
    from repro_torch.models import griffin, ssm
    kind = MIXER[arch]
    cfg = configs.smoke_config(arch)
    probe = jax_program[kind]
    assert probe["other"] == []
    calls, nbytes, dtypes = _jax_reduces(probe)
    D = cfg.d_model
    if kind == "ssd":
        assert [op for op in probe["all_reduce"]] == [
            [["f32", [ROWS, S]]], [["f32", [ROWS, S, D]]]]
        schema = ssm.ssd_schema(cfg)
    else:
        W = cfg.lru_width
        assert [op for op in probe["all_reduce"]] == [
            [["f32", [ROWS, S, W]], ["f32", [ROWS, S, W]]],
            [["f32", [ROWS, S, D]]]]
        schema = griffin.rglru_schema(cfg)
    trace = meshlib.TraceMesh(("data", "model"), (2, 2), 0,
                              torch.device("cpu"))
    gathered = [4 * int(np.prod(local_shape(d.shape, to_physical(
        d.logical, trace), trace))) * 2
        for _, d in leaves(schema) if "embed" in d.logical]
    for r in world[0]:
        got_calls, got_bytes, got_dtypes = r[arch]["mixer"]
        assert got_calls == {"psum": calls, "all_gather": len(gathered)}
        assert got_bytes == {"psum": nbytes, "all_gather": sum(gathered)}
        assert got_dtypes["psum"] == ["float32"] and dtypes == ["f32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_refuses_a_recurrent_leaf_off_the_rule_table(world, arch):
    leaf = "out_proj" if MIXER[arch] == "ssd" else "w_out"
    for r in world[0]:
        msg = r[arch]["refused"]
        assert msg is not None and "param_shardings disagree" in msg \
            and leaf in msg


def test_a_model_axis_that_does_not_divide_the_heads_is_refused(
        jax_program):
    """Reduced mamba2-780m's 8 heads on a model axis of 3: both packages
    refuse to place the leaves (the port's ``local_block``, JAX's
    ``device_put``), so no mixer on such a mesh runs at all."""
    from repro_torch.common.schema import init_params
    from repro_torch.models import ssm
    assert jax_program["model3"] is not None and \
        "divisible by 3" in jax_program["model3"]
    trace = meshlib.TraceMesh(("data", "model"), (1, 3), 0,
                              torch.device("cpu"))
    schema = ssm.ssd_schema(configs.smoke_config("mamba2-780m"))
    with pytest.raises(ValueError, match="split evenly"):
        init_params(schema, 0, device="cpu", mesh=trace)
