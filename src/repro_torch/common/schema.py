"""Parameter schemas: one declaration drives init.

A schema is a dict, nested to any depth, whose leaves are
:class:`ParamDef`; ``init_params`` turns it into tensors on a device, drawn
with numpy from a seed (or, with ``draw="device"``, with a
``torch.Generator`` on the device: a billion-parameter LM's draw takes
seconds there against minutes in numpy), ``stack`` prepends a layers axis
to every leaf (the stacked blocks of a layer stack), and
``tree_map_defs`` maps every leaf (the optimiser state's schema). A leaf
declared ``trainable=False`` is a buffer: the model reads it, the train
step takes no gradient of it and the optimiser keeps no state for it
(``frozen_paths``; the sigmoid router's selection bias). The JAX
package draws with ``jax.random``, so the two give different numbers from
one seed: to compare them, carry the JAX parameters across
(``repro_torch.core.gcn.params_from_jax``,
``repro_torch.models.transformer.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # one logical axis name per dim
    init: str = "lecun"                  # normal | zeros | ones | lecun | custom
    dtype: torch.dtype = torch.float32
    scale: Optional[float] = None        # stddev override for "normal"
    custom: Optional[str] = None         # the "custom" init's tag
    trainable: bool = True               # False: a buffer, no gradient

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


Schema = Dict[str, Any]   # nested dict of ParamDef


def leaves(schema: Schema, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], ParamDef]]:
    """(key path, ParamDef) of every leaf, in sorted-key order at every
    level (the order ``jax.tree.flatten`` gives a dict)."""
    for name in sorted(schema):
        node = schema[name]
        if isinstance(node, ParamDef):
            yield (*prefix, name), node
        else:
            yield from leaves(node, (*prefix, name))


def _fan_in(d: ParamDef) -> int:
    """The input width of one matrix: its first axis after the stacked
    layers axis where ``stack`` prepended one and after the experts axis
    of an MoE leaf. (The JAX package takes ``shape[0]`` even of a stacked
    or expert leaf, so its stacked matrices are drawn with the layer count
    as fan-in, and its experts with the expert count.)"""
    axes = list(zip(d.shape, d.logical))
    while axes and axes[0][1] in ("layers", "experts"):
        axes.pop(0)
    return max(axes[0][0], 1) if axes else 1


def _custom(tag: Optional[str], u: torch.Tensor) -> torch.Tensor:
    """The JAX package's custom inits, from ``u`` uniform in [0, 1)
    (float32)."""
    if tag == "rglru_lambda":
        # Λ such that a = exp(-8·softplus(Λ)·sigmoid(r)) starts with a^c in
        # [0.9, 0.999] (Griffin appendix): softplus(Λ) = -log(u) / 8 for u
        # uniform in [0.9², 0.999²], stored through the inverse softplus
        u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * u
        return torch.log(torch.expm1(-torch.log(u) / 8.0))
    if tag == "ssm_a_log":
        # mamba2: A uniform in [1, 16] per head, stored as its log
        return torch.log(1.0 + 15.0 * u)
    if tag == "ssm_dt_bias":
        # softplus(dt_bias) log-uniform in [1e-3, 1e-1]
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        return torch.log(torch.expm1(dt))
    raise ValueError(f"unknown init 'custom' with tag {tag!r}")


def _init_leaf(d: ParamDef, rng: np.random.Generator) -> np.ndarray:
    if d.init == "zeros":
        return np.zeros(d.shape, np.float32)
    if d.init == "ones":
        return np.ones(d.shape, np.float32)
    if d.init == "normal":
        std = d.scale if d.scale is not None else 0.02
        return (std * rng.standard_normal(d.shape, np.float32))
    if d.init == "lecun":
        return (rng.standard_normal(d.shape) / math.sqrt(_fan_in(d))
                ).astype(np.float32)
    if d.init == "custom" and d.custom is not None:
        return _custom(d.custom, torch.from_numpy(
            rng.random(d.shape, np.float32))).numpy()
    raise ValueError(f"unknown init {d.init!r}")


def _draw_leaf(d: ParamDef, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    """``_init_leaf``'s distributions, drawn by ``gen`` on ``dev``."""
    kw = dict(dtype=torch.float32, device=dev)
    if d.init == "zeros":
        return torch.zeros(d.shape, **kw)
    if d.init == "ones":
        return torch.ones(d.shape, **kw)
    if d.init == "normal":
        std = d.scale if d.scale is not None else 0.02
        return std * torch.randn(d.shape, generator=gen, **kw)
    if d.init == "lecun":
        return torch.randn(d.shape, generator=gen, **kw) / math.sqrt(
            _fan_in(d))
    if d.init == "custom" and d.custom is not None:
        return _custom(d.custom, torch.rand(d.shape, generator=gen, **kw))
    raise ValueError(f"unknown init {d.init!r}")


def init_params(schema: Schema, seed: int = 0, *,
                device: DeviceLike = "cuda", draw: str = "numpy",
                mesh=None) -> Dict[str, Any]:
    """Parameters for every ``ParamDef``, with the schema's nesting, in
    sorted-key order from one ``np.random.Generator(seed)``; each leaf in
    its ``dtype`` (drawn in float32, then cast). ``draw="device"`` draws
    the same distributions from one ``torch.Generator`` on ``device``
    seeded with ``seed``: other numbers, the same on every run of one
    device type. On a ``mesh`` every rank draws each full leaf and keeps
    its block (``shard_params``) before it draws the next, so a sharded
    run starts from the unsharded run's numbers and a rank holds at most
    one full leaf beside its blocks."""
    dev = resolve_device(device)
    if draw not in ("numpy", "device"):
        raise ValueError(f"unknown draw {draw!r}: 'numpy' or 'device'")
    if draw == "numpy":
        rng = np.random.default_rng(seed)
        make = lambda d: torch.from_numpy(_init_leaf(d, rng)).to(dev,
                                                                 d.dtype)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        make = lambda d: _draw_leaf(d, gen, dev).to(d.dtype)
    out: Dict[str, Any] = {}
    for path, d in leaves(schema):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        leaf = make(d)
        node[path[-1]] = leaf if mesh is None else _block(leaf, d, mesh)
    return out


def frozen_paths(schema: Schema) -> frozenset:
    """The key paths of the schema's buffers (``trainable=False``)."""
    return frozenset(p for p, d in leaves(schema) if not d.trainable)


def param_logical_specs(schema: Schema):
    """The tree of logical spec tuples (``common.logical
    .tree_to_physical`` maps it onto a mesh)."""
    return tree_map_defs(lambda d: tuple(d.logical), schema)


def param_structs(schema: Schema):
    """The tree of parameters as meta tensors: shape and dtype, no
    data."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), schema)


def shard_params(params, schema: Schema, mesh):
    """This rank's block of every full leaf of ``params`` under its
    ``ParamDef``'s logical axes on ``mesh``
    (``local_block(leaf, to_physical(d.logical, mesh))``)."""
    def place(node, sch):
        if isinstance(sch, ParamDef):
            return _block(node, sch, mesh)
        return {k: place(node[k], sch[k]) for k in node}
    return place(params, schema)


def _block(leaf: torch.Tensor, d: ParamDef, mesh) -> torch.Tensor:
    from repro_torch.common.logical import local_block, to_physical
    # a copy, so the full leaf's storage is freed
    return local_block(leaf, to_physical(d.logical, mesh), mesh).clone(
        memory_format=torch.contiguous_format)


def count_params(schema: Schema) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(schema))


def tree_map_defs(fn, schema: Schema) -> Schema:
    """``fn`` over every ``ParamDef`` of ``schema``, nesting kept."""
    return {k: fn(v) if isinstance(v, ParamDef) else tree_map_defs(fn, v)
            for k, v in schema.items()}


def stack(schema: Schema, n: int) -> Schema:
    """Prepend a layers axis of size ``n`` to every leaf."""
    return {k: dataclasses.replace(v, shape=(n, *v.shape),
                                   logical=("layers", *v.logical))
            if isinstance(v, ParamDef) else stack(v, n)
            for k, v in schema.items()}
