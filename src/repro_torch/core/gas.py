"""The gather-and-scatter (GAS) engine, forward and backward.

The paper's engine couples a CAM (parallel *match* of edge endpoints) with
a FAST SRAM (*row-parallel in-place update* of matched rows). Public
primitives:

  gas_scatter(dst, values, n_rows, op)   — scatter-reduce values into rows
  gas_gather(table, ids)                 — row gather (the "find")
  gas_scatter_weighted(...)              — masked, edge-weighted scatter
  gas_gather_scatter(table, src, ...)    — the two above fused: a weighted
                                           add of table[src] (kernel only)

``impl`` selects the backend: ``"ref"`` (``index_add_`` /
``scatter_reduce``, the oracle) or ``"kernel"`` (the FAST-GAS kernels in
``repro_torch.kernels.gas_scatter``, fused: mask and weights enter the
kernel).

**Differentiation.** ``impl="ref"`` differentiates through native
autograd (``scatter_reduce`` splits a max/min gradient evenly among ties,
as ``jax.ops.segment_max`` does). The kernel wrappers are forward-only, so
``impl="kernel"`` carries the JAX package's custom-VJP rules as
``torch.autograd.Function``s whose backward is itself GAS work:

* the backward of ``gas_gather`` is a kernel scatter-add of the cotangent
  (the dense grid, no schedule);
* the backward of ``gas_scatter_weighted(op="add")`` is a masked weighted
  gather plus a per-edge row-dot for the weights, with no kernel;
* for ``op="max"/"min"`` the cotangent routes through the equality mask
  against the saved output, split evenly among ties whose count comes from
  one kernel scatter under the forward's mask and schedule;
* ``op="or"`` is flat, so its gradients are stopped;
* ``gas_gather_scatter`` is ``gas_scatter_weighted(dst, gas_gather(table,
  src), …, op="add")`` in one dispatch: its forward is the banded walk
  reading each edge's row from the table, so nothing E×F is built or
  saved; its backward is the composition's, bit for bit: d_table is the
  dense-grid scatter-add by ``src`` of live · w · g[dst] (the gather's
  backward, in its ``gas.gather_backward`` span), and d_w = live ·
  ⟨table[src], g[dst]⟩ only where the weights require a gradient, the rows
  gathered again for it.

The forward runs under no-grad inside each ``Function``, so on the CPU the
kernels' plain versions are never differentiated in their place.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.device import check_impl
from repro_torch.kernels import entries
from repro_torch.kernels.gas_scatter import ops as gas_ops
from repro_torch.runtime import trace

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


class _GatherKernel(torch.autograd.Function):
    """Row gather whose backward scatter-adds the cotangent through the
    FAST-GAS kernel (JAX ``gas.py`` ``_gather_pallas``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        ctx.suspended = gas_ops.counting_suspended()
        ctx.call = trace.current_call()
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        with trace.span("gas.gather_backward", g, call=ctx.call), \
                gas_ops.suspend_counting(ctx.suspended):
            gf = g.reshape(-1, g.shape[-1]).to(torch.float32)
            # fused dispatch without mask or weights: out-of-range ids ride
            # the dead-row convention inside the kernel wrapper
            dtab = _scatter_weighted_impl(ids.reshape(-1), gf, None, None,
                                          ctx.n_rows, "add", "kernel")
        return dtab.to(ctx.dtype), None


def gas_gather(table: torch.Tensor, ids: torch.Tensor, *,
               impl: str = "ref") -> torch.Tensor:
    """Row gather — local by construction under the src-owner partition.
    ``impl="kernel"`` keeps the forward a plain index and routes the
    backward's scatter-add through the FAST-GAS kernel."""
    _tick("find")
    entries.note("find", table)
    if check_impl(impl) == "kernel":
        if table.dim() != 2:
            raise NotImplementedError(
                f"gas_gather(impl='kernel') routes its backward through the "
                f"FAST-GAS kernel and requires a 2-D (rows, F) table; got "
                f"ndim={table.dim()}. Use impl='ref' for other ranks.")
        return _GatherKernel.apply(table, ids)
    return table[ids.long()]


def _scatter_weighted_impl(dst, src_vals, weights, mask, n_rows: int, op: Op,
                           impl: str, schedule=None):
    """The computation behind ``gas_scatter_weighted`` on both backends.
    ``schedule`` is the banded idle-skip walk for pre-permuted inputs
    (kernel backend only)."""
    _tick("reduce")
    entries.note("reduce", src_vals, weights)
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


class _ScatterWeightedKernel(torch.autograd.Function):
    """``gas_scatter_weighted`` on the kernel backend with the JAX
    package's backward rules (``gas.py`` ``_scatter_weighted_pallas``):

      add      d_vals[e]   = live[e] · w[e] · g[dst[e]]
               d_w[e]      = live[e] · ⟨src_vals[e], g[dst[e]]⟩
      max/min  d_vals[e,f] = eq[e,f] · g[dst[e],f] / ties[dst[e],f]
               eq = live ∧ (src_vals == out[dst]), ties counted by one
               kernel scatter under the forward's mask and schedule;
               d_w = 0

    with live = mask ∧ 0 ≤ dst < n_rows (the fused kernel drops masked and
    out-of-range edges alike)."""

    @staticmethod
    def forward(ctx, dst, src_vals, weights, mask, n_rows, op, schedule):
        out = _scatter_weighted_impl(dst, src_vals, weights, mask, n_rows,
                                     op, "kernel", schedule)
        ctx.save_for_backward(dst, src_vals, weights, mask,
                              out if op in ("max", "min") else None)
        ctx.n_rows, ctx.op, ctx.schedule = n_rows, op, schedule
        ctx.suspended = gas_ops.counting_suspended()
        return out

    @staticmethod
    def backward(ctx, g):
        dst, src_vals, weights, mask, out = ctx.saved_tensors
        n_rows = ctx.n_rows
        live = mask & (dst >= 0) & (dst < n_rows)
        safe = torch.clamp(dst, 0, n_rows - 1).long()
        g_rows = g[safe]                  # dead edges read junk rows …
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        if ctx.op == "add":               # … zeroed by `live` here
            d_vals = torch.where(live[:, None],
                                 g_rows * weights[:, None].to(g.dtype),
                                 zero).to(src_vals.dtype)
            d_w = torch.where(
                live, (src_vals.to(torch.float32)
                       * g_rows.to(torch.float32)).sum(-1),
                torch.zeros((), dtype=torch.float32, device=g.device)
            ).to(weights.dtype)
            return None, d_vals, d_w, None, None, None, None
        # the CAM match lines as the grad router: an edge takes part in the
        # row's extremum iff it equals the saved output there (and is live)
        eq = live[:, None] & (src_vals == out[safe])
        with gas_ops.suspend_counting(ctx.suspended):
            ties = _scatter_weighted_impl(dst, eq.to(torch.float32), None,
                                          mask, n_rows, "add", "kernel",
                                          ctx.schedule)
        share = g_rows / torch.clamp(ties[safe], min=1.0)
        d_vals = torch.where(eq, share, zero).to(src_vals.dtype)
        return (None, d_vals, torch.zeros_like(weights), None, None, None,
                None)


class _GatherScatterKernel(torch.autograd.Function):
    """``gas_gather_scatter``: the fused forward and the composition's
    backward rules (module docstring)."""

    @staticmethod
    def forward(ctx, table, src, dst, weights, mask, n_rows, schedule):
        _tick("reduce")
        entries.note("reduce", table, weights)
        out = gas_ops.gas_scatter_fused(dst, table, weights, mask, n_rows,
                                        schedule=schedule, src=src)
        ctx.save_for_backward(table if ctx.needs_input_grad[3] else None,
                              src, dst, weights, mask)
        ctx.n_rows, ctx.table_rows = n_rows, table.shape[0]
        ctx.dtype = table.dtype
        ctx.suspended = gas_ops.counting_suspended()
        ctx.call = trace.current_call()
        return out

    @staticmethod
    def backward(ctx, g):
        table, src, dst, weights, mask = ctx.saved_tensors
        n_rows = ctx.n_rows
        live = mask & (dst >= 0) & (dst < n_rows)
        g_rows = g[torch.clamp(dst, 0, n_rows - 1).long()]
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            d_vals = torch.where(live[:, None],
                                 g_rows * weights[:, None].to(g.dtype),
                                 torch.zeros((), dtype=g.dtype,
                                             device=g.device)).to(ctx.dtype)
            with trace.span("gas.gather_backward", d_vals, call=ctx.call), \
                    gas_ops.suspend_counting(ctx.suspended):
                d_table = _scatter_weighted_impl(
                    src, d_vals.to(torch.float32), None, None,
                    ctx.table_rows, "add", "kernel").to(ctx.dtype)
        if ctx.needs_input_grad[3]:
            d_w = torch.where(
                live, (table[src.long()].to(torch.float32)
                       * g_rows.to(torch.float32)).sum(-1),
                torch.zeros((), dtype=torch.float32, device=g.device)
            ).to(weights.dtype)
        return d_table, None, None, d_w, None, None, None


def gas_gather_scatter(table: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, weights: torch.Tensor,
                       mask: torch.Tensor, n_rows: int, *,
                       schedule: gas_ops.EdgeSchedule) -> torch.Tensor:
    """``gas_scatter_weighted(dst, gas_gather(table, src), weights, mask,
    n_rows, op="add", impl="kernel", schedule=schedule)`` in one kernel
    dispatch, bit for bit, forward and backward: the banded walk reads each
    edge's row ``table[src[e]]`` itself. ``table`` (V, F) float32, the
    per-edge arrays in ``schedule``'s order. Ticks ``reduce`` and
    ``kernel_scatter`` as the scatter does; the find's tick is its
    caller's (``cgtrans._agg_local``)."""
    return _GatherScatterKernel.apply(table, src, dst, weights, mask, n_rows,
                                      schedule)


def gas_scatter_weighted(dst: torch.Tensor, src_vals: torch.Tensor,
                         weights: torch.Tensor, mask: torch.Tensor,
                         n_rows: int, *, op: Op = "add", impl: str = "ref",
                         schedule: Optional[gas_ops.EdgeSchedule] = None
                         ) -> torch.Tensor:
    """Masked, edge-weighted scatter — the paper's aggregation atom.

    src_vals: (E, F); weights/mask: (E,). Invalid edges are routed to a
    dead row and sliced off. On the kernel backend the dispatch is fused:
    mask and weights enter the kernel, no E×F staging. ``schedule`` (an
    ``EdgeSchedule`` whose ``perm`` order the inputs are already in) swaps
    the dense grid for the banded walk, in the forward and in the max/min
    tie count of the backward. Differentiable in ``src_vals`` and
    ``weights`` on both backends; ``op="or"`` is flat and its gradients
    are stopped.
    """
    if check_impl(impl) == "kernel":
        if op == "or":
            return _scatter_weighted_impl(dst, src_vals.detach(),
                                          weights.detach(), mask, n_rows, op,
                                          impl, schedule)
        return _ScatterWeightedKernel.apply(dst, src_vals, weights, mask,
                                            n_rows, op, schedule)
    return _scatter_weighted_impl(dst, src_vals, weights, mask, n_rows, op,
                                  impl, schedule)
