"""The gather-and-scatter (GAS) engine, forward only.

The paper's engine couples a CAM (parallel *match* of edge endpoints) with
a FAST SRAM (*row-parallel in-place update* of matched rows). Public
primitives:

  gas_scatter(dst, values, n_rows, op)   — scatter-reduce values into rows
  gas_gather(table, ids)                 — row gather (the "find")
  gas_scatter_weighted(...)              — masked, edge-weighted scatter

``impl`` selects the backend: ``"ref"`` (``index_add_`` /
``scatter_reduce``, the oracle) or ``"kernel"`` (the FAST-GAS kernels in
``repro_torch.kernels.gas_scatter``, fused: mask and weights enter the
kernel). Serving runs under ``torch.no_grad()``; the backward rules of the
JAX package's custom VJPs are not ported yet.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.device import check_impl
from repro_torch.kernels.gas_scatter import ops as gas_ops

Op = Literal["add", "max", "min", "or"]

_INIT = {
    "add": 0.0,
    "max": float("-inf"),
    "min": float("inf"),
    "or": 0,
}

count_dispatches = gas_ops.count_dispatches
schedule_edges = gas_ops.schedule_edges
_tick = gas_ops._tick


def _segment_reduce_ref(dst: torch.Tensor, values: torch.Tensor,
                        n_rows: int, op: Op) -> torch.Tensor:
    """``jax.ops.segment_*`` semantics: out-of-range ids are dropped, empty
    segments hold 0 (add) or ∓inf (max/min); ``or`` reduces int-cast values
    with an or-identity of 0."""
    if op in ("add", "max", "min"):
        return gas_ops.gas_scatter_ref(dst, values, n_rows, op=op)
    if op == "or":
        iv = values.to(torch.int32)
        vals = iv if iv.dim() > 1 else iv[:, None]
        ok = (dst >= 0) & (dst < n_rows)
        safe = torch.where(ok, dst, torch.full_like(dst, n_rows)).long()
        out = torch.full((n_rows + 1, vals.shape[1]),
                         torch.iinfo(torch.int32).min, dtype=torch.int32,
                         device=vals.device)
        out.scatter_reduce_(0, safe[:, None].expand_as(vals), vals, "amax",
                            include_self=True)
        out = out[:n_rows] if iv.dim() > 1 else out[:n_rows, 0]
        # empty segments come back as INT32_MIN; the or-identity is 0
        return torch.clamp(out, min=0).to(values.dtype)
    raise ValueError(op)


def gas_scatter(dst: torch.Tensor, values: torch.Tensor, n_rows: int, *,
                op: Op = "add", impl: str = "ref") -> torch.Tensor:
    """Scatter-reduce ``values`` (E,) or (E, F) into ``n_rows`` rows by
    ``dst``. Rows with no incoming edge hold the op identity for max/min
    (±inf). ``impl="kernel"`` routes through the dense-grid FAST-GAS
    kernel."""
    if check_impl(impl) == "kernel":
        return gas_ops.gas_scatter(dst, values, n_rows, op=op)
    return _segment_reduce_ref(dst, values, n_rows, op)


def gas_gather(table: torch.Tensor, ids: torch.Tensor, *,
               impl: str = "ref") -> torch.Tensor:
    """Row gather — local by construction under the src-owner partition."""
    _tick("find")
    if check_impl(impl) == "kernel" and table.dim() != 2:
        raise NotImplementedError(
            f"gas_gather(impl='kernel') requires a 2-D (rows, F) table; got "
            f"ndim={table.dim()}. Use impl='ref' for other ranks.")
    return table[ids.long()]


def _scatter_weighted_impl(dst, src_vals, weights, mask, n_rows: int, op: Op,
                           impl: str, schedule=None):
    """The computation behind ``gas_scatter_weighted`` on both backends.
    ``schedule`` is the banded idle-skip walk for pre-permuted inputs
    (kernel backend only)."""
    _tick("reduce")
    if check_impl(impl) == "kernel":
        if op == "or":
            # boolean-or ignores edge weights; the int round trip matches
            # the oracle's truncation exactly, so both backends agree even
            # on non-{0,1} values
            vals = src_vals.to(torch.int32).to(torch.float32)
            out = gas_ops.gas_scatter_fused(dst, vals, None, mask, n_rows,
                                            op="max", schedule=schedule)
            return torch.clamp(out, min=0).to(src_vals.dtype)
        w = weights if op == "add" else None
        return gas_ops.gas_scatter_fused(dst, src_vals, w, mask, n_rows,
                                         op=op, schedule=schedule)
    m = mask[:, None]
    if op in ("max", "min"):
        vals = torch.where(m, src_vals, torch.full((), _INIT[op],
                                                   dtype=src_vals.dtype,
                                                   device=src_vals.device))
    elif op == "or":
        # boolean-or ignores edge weights (see the kernel branch above)
        vals = torch.where(m, src_vals, torch.zeros((), dtype=src_vals.dtype,
                                                    device=src_vals.device))
    else:
        vals = src_vals * weights[:, None].to(src_vals.dtype)
        vals = torch.where(m, vals, torch.zeros((), dtype=vals.dtype,
                                                device=vals.device))
    safe_dst = torch.where(mask, dst, torch.full_like(dst, n_rows))
    out = gas_scatter(safe_dst, vals, n_rows + 1, op=op, impl=impl)
    return out[:n_rows]


def gas_scatter_weighted(dst: torch.Tensor, src_vals: torch.Tensor,
                         weights: torch.Tensor, mask: torch.Tensor,
                         n_rows: int, *, op: Op = "add", impl: str = "ref",
                         schedule=None) -> torch.Tensor:
    """Masked, edge-weighted scatter — the paper's aggregation atom.

    src_vals: (E, F); weights/mask: (E,). Invalid edges are routed to a
    dead row and sliced off. On the kernel backend the dispatch is fused:
    mask and weights enter the kernel, no E×F staging. ``schedule`` (an
    ``EdgeSchedule`` whose ``perm`` order the inputs are already in) swaps
    the dense grid for the banded walk.
    """
    return _scatter_weighted_impl(dst, src_vals, weights, mask, n_rows, op,
                                  impl, schedule)
