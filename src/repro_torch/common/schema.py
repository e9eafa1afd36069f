"""Parameter schemas: one declaration drives init.

A schema is a dict, nested to any depth, whose leaves are
:class:`ParamDef`; ``init_params`` turns it into tensors on a device, drawn
with numpy from a seed, and ``stack`` prepends a layers axis to every leaf
(the stacked blocks of a layer stack). The JAX package draws with
``jax.random``, so the two give different numbers from one seed: to
compare them, carry the JAX parameters across
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
    init: str = "lecun"                  # normal | zeros | ones | lecun
    dtype: torch.dtype = torch.float32
    scale: Optional[float] = None        # stddev override for "normal"

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
    """The input width of one layer's matrix: its first axis, after the
    stacked layers axis where ``stack`` prepended one. (The JAX package
    takes ``shape[0]`` even of a stacked leaf, so its stacked matrices are
    drawn with the layer count as fan-in.)"""
    shape = d.shape[1:] if d.logical[:1] == ("layers",) else d.shape
    return max(shape[0], 1) if shape else 1


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
    raise ValueError(f"unknown init {d.init!r}")


def init_params(schema: Schema, seed: int = 0, *,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Parameters for every ``ParamDef``, with the schema's nesting, in
    sorted-key order from one ``np.random.Generator(seed)``; each leaf in
    its ``dtype`` (drawn in float32, then cast)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for path, d in leaves(schema):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.from_numpy(_init_leaf(d, rng)).to(
            dev, d.dtype)
    return out


def count_params(schema: Schema) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(schema))


def stack(schema: Schema, n: int) -> Schema:
    """Prepend a layers axis of size ``n`` to every leaf."""
    return {k: dataclasses.replace(v, shape=(n, *v.shape),
                                   logical=("layers", *v.logical))
            if isinstance(v, ParamDef) else stack(v, n)
            for k, v in schema.items()}
