"""Parameter schemas: one declaration drives init.

A schema is a flat dict whose values are :class:`ParamDef`; ``init_params``
turns it into float32 tensors on a device, drawn with numpy from a seed.
The JAX package draws with ``jax.random``, so the two give different
numbers from one seed: to compare them, carry the JAX parameters across
(``repro_torch.core.gcn.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # one logical axis name per dim
    init: str = "lecun"                  # lecun | zeros

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


Schema = Dict[str, ParamDef]


def _init_leaf(d: ParamDef, rng: np.random.Generator) -> np.ndarray:
    if d.init == "zeros":
        return np.zeros(d.shape, np.float32)
    if d.init == "lecun":
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        return (rng.standard_normal(d.shape) / math.sqrt(fan_in)
                ).astype(np.float32)
    raise ValueError(f"unknown init {d.init!r}")


def init_params(schema: Schema, seed: int = 0, *,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Float32 parameters for every ``ParamDef``, in sorted-name order from
    one ``np.random.Generator(seed)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(_init_leaf(schema[name], rng)).to(dev)
            for name in sorted(schema)}

