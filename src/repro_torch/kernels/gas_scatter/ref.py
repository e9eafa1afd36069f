"""Plain PyTorch oracles for the FAST-GAS scatter (``index_add_`` /
``scatter_reduce``), the counterparts of ``jax.ops.segment_*``."""

from __future__ import annotations

from typing import Optional

import torch

_FILL = {"add": 0.0, "max": float("-inf"), "min": float("inf")}


def gas_scatter_ref(dst: torch.Tensor, values: torch.Tensor, n_rows: int, *,
                    op: str = "add") -> torch.Tensor:
    """dst: (E,) row ids; values: (E,) or (E, F). Returns (n_rows[, F]).

    Out-of-range dst (e.g. the dead-row convention) contribute nothing.
    max/min leave ∓inf in untouched rows (mask with a count if needed).
    """
    if op not in _FILL:
        raise ValueError(op)
    ok = (dst >= 0) & (dst < n_rows)
    safe = torch.where(ok, dst, torch.full_like(dst, n_rows)).long()
    vals = values if values.dim() > 1 else values[:, None]
    out = torch.full((n_rows + 1, vals.shape[1]), _FILL[op], dtype=vals.dtype,
                     device=vals.device)
    if op == "add":
        out.index_add_(0, safe, vals)
    else:
        out.scatter_reduce_(0, safe[:, None].expand_as(vals), vals,
                            "amax" if op == "max" else "amin",
                            include_self=True)
    out = out[:n_rows]
    return out if values.dim() > 1 else out[:, 0]


def gas_scatter_weighted_ref(dst: torch.Tensor, values: torch.Tensor,
                             weights: Optional[torch.Tensor],
                             mask: Optional[torch.Tensor], n_rows: int, *,
                             op: str = "add") -> torch.Tensor:
    """Oracle for ``ops.gas_scatter_fused``: masked, weighted scatter-reduce.

    Weights scale contributions only under ``op="add"`` (compare ops take
    the raw value); masked edges contribute nothing on any op.
    """
    ok = (dst >= 0) & (dst < n_rows)
    if mask is not None:
        ok = ok & mask
    if op == "add" and weights is not None:
        values = values * weights.to(values.dtype).reshape(
            (-1,) + (1,) * (values.dim() - 1))
    dead = torch.full_like(dst, n_rows)
    return gas_scatter_ref(torch.where(ok, dst, dead), values, n_rows, op=op)
