"""AdamW + cosine schedule + global-norm clipping + int8 error-feedback
gradient compression, on trees (nested dicts) of tensors.

The arithmetic is the JAX package's (``repro.optim.adamw``), not
``torch.optim.AdamW``'s: the bias-corrected step is
``(m / bc1) / (sqrt(v / bc2) + eps)``, weight decay enters as
``p − lr·(step + wd·p)``, the step count is an int32 tensor, and norms sum
the leaves in sorted-key order. Compression (``int8_ef``): each leaf is
scale-quantized to int8 and the quantization residual is carried in the
optimiser state and re-added next step (error feedback).
``opt_state_schema`` is ``adamw_init``'s state as a schema (no
allocation).

On a mesh (``mesh=`` with ``specs``, the parameters' physical specs) every
leaf is this rank's block: AdamW is elementwise on it, and the norms and
the int8 scales cover the whole leaf — each block's sum of squares
counts once however many ranks hold it (divided by its ``replication``,
then summed over every rank), and each leaf's max |g| is the max over
every rank. One all-reduce each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.logical import replication, spec_leaves
from repro_torch.common.schema import ParamDef, tree_map_defs
from repro_torch.common.tree import leaves, tree_map, unflatten
from repro_torch.runtime import trace


def cosine_lr(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then a cosine decay to
    ``min_lr_ratio`` of it at ``total_steps``; float32 like ``step / n``."""
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = tc.min_lr_ratio + (1 - tc.min_lr_ratio) * cos
    return tc.learning_rate * warm * scale


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm over every leaf; on a mesh of the whole leaves whose
    blocks ``tree`` holds under ``specs``."""
    if mesh is None:
        total = sum(torch.sum(torch.square(x.to(torch.float32)))
                    for x in leaves(tree))
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    from repro_torch.core import collectives
    parts = torch.stack([
        torch.sum(torch.square(x.to(torch.float32))) / replication(s, mesh)
        for x, (_, s) in zip(leaves(tree), spec_leaves(specs))])
    return torch.sqrt(collectives.all_reduce(parts, mesh).sum())


def clip_by_global_norm(tree, max_norm: float, mesh=None, specs=None):
    norm = global_norm(tree, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


# --- int8 error-feedback compression ---------------------------------------

def quantize_int8(x: torch.Tensor, amax: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and their scale, max |x| / 127 (``amax``: the max |x|
    of the whole leaf ``x`` is a block of)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, residual, mesh=None):
    """Returns (dequantized grads as transmitted, new residual)."""
    gs = leaves(grads)
    g32s = [g.to(torch.float32) + r for g, r in zip(gs, leaves(residual))]
    amax = [None] * len(g32s)
    if mesh is not None:
        from repro_torch.core import collectives
        amax = collectives.all_reduce(
            torch.stack([torch.max(torch.abs(g)) for g in g32s]), mesh,
            op="max").unbind()
    deq, res = [], []
    for g, g32, m in zip(gs, g32s, amax):
        q, s = quantize_int8(g32, m)
        d = q.to(torch.float32) * s
        deq.append(d.to(g.dtype))
        res.append((g32 - d).to(torch.float32))
    return unflatten(grads, deq), unflatten(residual, res)


# --- AdamW ------------------------------------------------------------------

def adamw_init(params, tc: TrainConfig) -> Dict[str, Any]:
    zeros = lambda p: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        p)
    device = leaves(params)[0].device
    state = {"m": zeros(params), "v": zeros(params),
             "count": torch.zeros((), dtype=torch.int32, device=device)}
    if tc.grad_compression == "int8_ef":
        state["ef_residual"] = zeros(params)
    return state


@torch.no_grad()
def adamw_update(params, grads, opt_state, tc: TrainConfig, *, mesh=None,
                 specs=None):
    """Returns (params, opt_state, metrics), the parameters and the
    optimiser state updated in place: the state passed in is consumed, as
    the JAX step's donated state is, and no second copy of it is ever
    live. A caller that reads the old values after the update clones them
    first. On a mesh, ``specs`` are the parameters' physical specs."""
    with trace.span("adamw.update", opt_state["count"]):
        metrics = {}
        if tc.grad_compression == "int8_ef":
            grads, new_res = compress_grads(grads, opt_state["ef_residual"],
                                            mesh)
            metrics["ef_residual_norm"] = global_norm(new_res, mesh, specs)
            for r, n in zip(leaves(opt_state["ef_residual"]), leaves(new_res)):
                r.copy_(n)

        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, mesh, specs)
        metrics["grad_norm"] = gnorm

        count = opt_state["count"].add_(1)
        lr = cosine_lr(count, tc)
        metrics["lr"] = lr
        b1, b2 = tc.beta1, tc.beta2
        bc1 = 1 - b1 ** count.to(torch.float32)
        bc2 = 1 - b2 ** count.to(torch.float32)

        # leaf by leaf, the out-of-place arithmetic copied into the old
        # storage: the same roundings as building new tensors, and at most one
        # leaf's temporaries live at a time
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(opt_state["m"]), leaves(opt_state["v"])):
            g32 = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * torch.square(g32))
            step = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
            p32 = p.to(torch.float32)
            p.copy_((p32 - lr * (step + tc.weight_decay * p32)).to(p.dtype))
            del g32, step, p32
        return params, opt_state, metrics


def opt_state_schema(param_schema, tc: TrainConfig):
    """Schema mirror of ``adamw_init``: f32 m and v (and the int8_ef
    residual) shaped as the parameters, and the int32 step count."""
    f32 = lambda d: dataclasses.replace(d, dtype=torch.float32, init="zeros")
    s = {"m": tree_map_defs(f32, param_schema),
         "v": tree_map_defs(f32, param_schema),
         "count": ParamDef((), (), init="zeros", dtype=torch.int32)}
    if tc.grad_compression == "int8_ef":
        s["ef_residual"] = tree_map_defs(f32, param_schema)
    return s
