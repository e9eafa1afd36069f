"""Shared helpers of the LM parity tests (``test_torch_lm_train.py``,
``test_torch_lm_kinds.py``): parameters drawn by the JAX package and
carried across, JAX and port training states built from them, and tree
comparisons."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.common.config import TrainConfig as JTrainConfig
from repro.common.schema import ParamDef as JParamDef
from repro.common.schema import init_params as j_init_params
from repro.models import transformer as JT
from repro.optim import adamw_init as j_adamw_init
from repro_torch.common.config import TrainConfig
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init

# AdamW's first step sends every gradient element through g / (|g| + eps):
# at the default eps 1e-8 an element whose true gradient is zero (a key
# bias: softmax is shift-invariant) or at the f32 rounding floor (~1e-8)
# steps by up to ±lr on its rounding noise, in either package. eps 1e-3
# keeps the update a smooth function of the gradient at that floor, so
# parameters can be held to 1e-5; the gradients themselves are held at
# the default eps's step through ``loss_fn`` directly.
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, eps=1e-3)


def config_fields(tcfg, jcfg):
    """(the port's config fields that the JAX config has, the JAX
    config's), as dicts, after checking that every field the port adds
    (``common/config.py``'s "port only") sits at its default, which means
    what the JAX package does."""
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(j) <= set(t)
    own = {f.name: f.default for f in dataclasses.fields(tcfg)
           if f.name not in j}
    assert {k: t[k] for k in own} == own
    return {k: v for k, v in t.items() if k in j}, j


def jax_draw(schema, seed=0):
    """The JAX package's draw of ``schema`` as numpy arrays, each
    ``lecun`` matrix rescaled to one matrix's fan-in: its first axis after
    the stacked layers axis and the experts axis. (The JAX init takes a
    leaf's first axis, the layer count or the expert count there;
    ROADMAP's reference caveats.)"""
    def leaf(d, a):
        a = np.asarray(a)
        if d.init == "lecun" and len(d.shape) >= 2:
            fan = next(n for n, ax in zip(d.shape, d.logical)
                       if ax not in ("layers", "experts"))
            a = a * np.float32(np.sqrt(d.shape[0] / fan))
        return a

    return jax.tree.map(leaf, schema,
                        j_init_params(schema, jax.random.PRNGKey(seed)),
                        is_leaf=lambda x: isinstance(x, JParamDef))


def jax_params(cfg, max_seq, seed=0):
    """``jax_draw`` of the whole model's schema."""
    return jax_draw(JT.model_schema(cfg, max_seq=max_seq), seed)


def states(jp, **kw):
    """(JAX state, port state, JAX TrainConfig, port TrainConfig) from the
    numpy parameters ``jp``: zero AdamW state, step 0."""
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": j_adamw_init(jp, jtc), "step": jnp.zeros((), jnp.int32)}
    params = TT.params_from_jax(jp, device="cpu")
    tstate = {"params": params, "opt": adamw_init(params, ttc),
              "step": torch.zeros((), dtype=torch.int32)}
    return jstate, tstate, jtc, ttc


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return (tree.detach().numpy() if torch.is_tensor(tree)
            else np.asarray(tree))


def assert_trees(got, want, path="", **tol):
    """Leaf for leaf: same keys, shapes and dtypes; values within ``tol``,
    or bit for bit without one."""
    got, want = np_tree(got), np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees(got[k], want[k], f"{path}/{k}", **tol)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if tol:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def shapes(tree, path=()):
    """{key path: (shape, dtype name)} of a tree of ParamDefs, arrays,
    tensors or shape-dtype structs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, (*path, k)))
        return out
    dt = tree.dtype
    name = (str(dt).replace("torch.", "") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)
    return {path: (tuple(tree.shape), name)}
