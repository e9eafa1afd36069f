"""Dry-run case assembly: (arch × shape × mesh) → one rank's step and its
arguments as fake tensors.

The port's copy of the JAX package's ``launch/specs.py``. JAX compiles the
global program from ``ShapeDtypeStruct`` stand-ins and its shardings; the
port runs one rank's program, so ``build_case`` gives that rank's blocks
of every argument (``common.logical.local_shape`` of each leaf under
``to_physical(spec, mesh, rules_for(shape))``) as fake tensors
(``torch._subclasses.fake_tensor``): shapes and dtypes, no data, no
memory, no draw. ``launch/dryrun.py`` traces the step on them.

The fake tensors live on the card (``device="cuda"``) where this build of
PyTorch links CUDA. A CPU-only build cannot carry a fake CUDA tensor
through autograd or Python indexing (both take a CUDA device guard, which
it lacks), so there the fake tensors are CPU tensors; the counts read
shapes and dtypes only and do not depend on the device
(``tests/test_torch_dryrun.py`` holds a fake trace equal to a real run).

Per-shape logical rule overrides, as in the JAX package:
  * long_500k (global_batch=1): "batch" resolves to no axis, so every
    rank holds the B = 1 token and the steps sum nothing over ``pod`` or
    ``data`` (``logical.batch_axes(mesh, rules)``); "seq_shard" takes
    ("pod","data"), which no schema of either package reads.

The serving cases lay their caches out as the JAX cache schema does
(``cache_layout="seq"``): a full cache's sequence over ``seq_kv`` (→
``model``), rings and cross caches replicated over ``model``, every kv
head; a recurrent state's heads (``ssm_heads``) or channels (``lru``)
over ``model`` under every shape's rules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.common.logical import (DEFAULT_RULES, local_shape,
                                        tree_to_physical)
from repro_torch.common.schema import (param_logical_specs, param_structs,
                                       tree_map_defs)
from repro_torch.common.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.layers import tp_size
from repro_torch.train import step as S

LONG_CONTEXT_RULES = dict(
    DEFAULT_RULES,
    batch=(),                      # B=1: nothing to shard
    seq_shard=("pod", "data"),     # SP over the full fleet
)

# Per-arch gradient-accumulation microbatches for train_4k, the JAX
# package's table: the step runs B/mb rows at a time.
TRAIN_MICROBATCHES = {
    "llama-3.2-vision-90b": 8,
    "gemma2-2b": 2,
    "recurrentgemma-2b": 2,
    "phi3-medium-14b": 4,
    "gemma3-12b": 4,
    "moonshot-v1-16b-a3b": 2,
    "deepseek-moe-16b": 2,
    "mamba2-780m": 4,
}


def rules_for(shape: ShapeConfig, cfg: ModelConfig = None) -> dict:
    return LONG_CONTEXT_RULES if shape.name == "long_500k" else DEFAULT_RULES


def fake_device() -> str:
    """Where ``build_case``'s fake tensors live: the card where this build
    links CUDA, else the CPU."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: str
    fn: Callable                   # one rank's step, positional arguments
    args: Tuple[Any, ...]          # its fake arguments
    fake_mode: Any                 # the FakeTensorMode ``args`` belong to
    arg_bytes: int = 0             # the rank's blocks of every argument
    cache_bytes: int = 0           # the rank's decode caches (in or out)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tc: Optional[TrainConfig] = None, *, device: str = None,
               impl: str = "ref", use_flash: bool = False) -> DryRunCase:
    """One rank's (of ``mesh``, a ``launch.mesh`` mesh, or ``None`` for
    one unsharded device) step at ``shape`` and its fake arguments:

    * train: the f32 state with AdamW's moments, and the batch; the step
      updates the state in place (it consumes it, as the JAX case's
      ``donate=(0,)`` does), so one copy of the state is live;
    * prefill: bf16 parameters (the serving dtype), the tokens (+ frames
      / vision); the caches come out in the ``"seq"`` layout;
    * decode: bf16 parameters, the (B, 1) token, the caches in the
      ``"seq"`` layout (the JAX package's cache schema, as the prefill
      builds them), and the last position as a host int.

    Every serving placement and step reads the shape's rule table
    (``rules_for``).

    A rank holds its block of each parameter, moment and cache. The
    port's steps take the global batch (or token) and split off the
    rank's rows themselves (``train/step.py``), so that argument is whole;
    ``arg_bytes`` counts the rank's rows of it, as the JAX dry run's
    per-device argument bytes do.

    ``impl`` is the backend of the CGTrans lookup's gradient (a train
    step on a mesh) and ``use_flash`` sends full-sequence attention
    through the flash kernel: neither kernel launches on a fake tensor,
    so a trace with either raises (the JAX dry run compiles
    ``impl="ref"`` and ``use_flash=False``).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    if tc is None:
        tc = TrainConfig(microbatches=TRAIN_MICROBATCHES.get(cfg.name, 1))
    device = device or fake_device()
    rules = rules_for(shape, cfg)
    max_seq = shape.seq_len if cfg.is_encoder_decoder else 0
    mode = FakeTensorMode()

    def place(structs, logical, whole=False):
        """(fake tensors of the rank's blocks of ``structs`` — ``whole``:
        of the structs themselves —, their physical specs, the blocks'
        bytes)."""
        phys = (None if mesh is None
                else tree_to_physical(logical, mesh, rules))
        nbytes = [0]

        def make(t, spec=None):
            block = (tuple(t.shape) if mesh is None
                     else local_shape(tuple(t.shape), spec, mesh))
            nbytes[0] += math.prod(block) * t.element_size()
            with mode:
                return torch.empty(tuple(t.shape) if whole else block,
                                   dtype=t.dtype, device=device)

        out = (tree_map(make, structs) if mesh is None
               else tree_map(make, structs, phys))
        return out, phys, nbytes[0]

    if shape.kind == "train":
        schema = S.state_schema(cfg, tc, max_seq=max_seq)
        state, phys, n_state = place(param_structs(schema),
                                     param_logical_specs(schema))
        batch, _, n_batch = place(S.batch_structs(cfg, shape),
                                  S.batch_logical_specs(cfg), whole=True)
        fn = S.make_train_step(
            cfg, tc, mesh=mesh, use_flash=use_flash, impl=impl,
            param_shardings=None if mesh is None else phys["params"])
        return DryRunCase(cfg.name, shape.name, fn, (state, batch), mode,
                          n_state + n_batch)

    # serving traces bf16 parameters, the production deployment dtype
    raw = T.model_schema(cfg, max_seq=max_seq)
    bf16 = tree_map_defs(
        lambda d: dataclasses.replace(d, dtype=torch.bfloat16)
        if d.dtype == torch.float32 else d, raw)
    params, _, n_params = place(param_structs(bf16),
                                param_logical_specs(bf16))
    tp = tp_size(mesh)
    tok_spec, cache_spec, _ = S.decode_logical_specs(cfg, shape, tp,
                                                     layout="seq")
    tok_s, cache_s, _ = S.decode_structs(cfg, shape, tp, layout="seq")
    caches, _, n_cache = place(cache_s, cache_spec)

    if shape.kind == "prefill":
        bs, spec = S.batch_structs(cfg, shape), S.batch_logical_specs(cfg)
        bs.pop("labels")
        spec.pop("labels")
        batch, _, n_batch = place(bs, spec, whole=True)
        fn = S.make_prefill_step(cfg, cache_len=shape.seq_len, mesh=mesh,
                                 use_flash=use_flash, rules=rules,
                                 cache_layout="seq")
        # the caches come out of the step: not an argument
        return DryRunCase(cfg.name, shape.name, fn, (params, batch), mode,
                          n_params + n_batch, n_cache)

    if shape.kind == "decode":
        token, _, n_token = place(tok_s, tok_spec, whole=True)
        fn = S.make_decode_step(cfg, mesh=mesh, rules=rules,
                                cache_layout="seq")
        return DryRunCase(cfg.name, shape.name, fn,
                          (params, token, caches, shape.seq_len - 1), mode,
                          n_params + n_token + n_cache, n_cache)

    raise ValueError(shape.kind)
