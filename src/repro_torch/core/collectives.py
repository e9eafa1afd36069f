"""The sharded dataflows' collectives, counted.

Every collective of the port goes through this module, over a
``repro_torch.launch.mesh.DataMesh``: ``all_gather`` (into a tensor),
``all_to_all`` (single), ``all_reduce`` and ``reduce_scatter``. The three
that carry values into the loss are ``torch.autograd.Function``s with the
transposes JAX gives them: the backward of an ``all_to_all`` is an
``all_to_all``, the backward of an ``all_gather`` a ``reduce_scatter``, and
the backward of a ``reduce_scatter`` (JAX's ``psum_scatter``) an
``all_gather``. An integer stream (the request ids) carries no gradient.

gloo and NCCL have no int16 (and gloo no bool): a payload of such a dtype
(the compressed wire's bf16 bits and delta ids) ships as a ``uint8`` view
of the same bytes, here and nowhere else, and counts its logical bytes, so
the byte counts equal the JAX package's.

``count_collectives()`` is the port's counterpart of
``repro.launch.jaxpr_stats``'s collective counts: every call ticks the
innermost context under the name of the JAX primitive it stands for
(``all_gather``, ``all_to_all``, ``psum``, ``psum_scatter``) with its bytes,
``max(input, output)`` as the JAX package's HLO byte count takes them,
and the payload's logical dtype (the tensor the caller passed, before
any ``uint8`` view), which ``analysis/dtype_flow.py`` reads.
Collectives that JAX issues outside the traced program have keys of their
own: ``grad_all_reduce`` (GSPMD's gradient reduction of a data-parallel
step), ``metric_all_reduce`` (the global loss and accuracy),
``result_gather`` (the host reading a seed-sharded result) and
``trigger_broadcast`` (the serving queue's drain decision); so does
``relabel_gather``, the un-permute of islandized full-graph logits, an
all_gather where the JAX program holds an all-reduce of the same rows
(``analysis/budgets.py``). Counting
follows the GAS dispatch counter: a call site counts once per program, so
a chunk loop (``cgtrans.scan_request_chunks``) counts its body once, as a
``lax.scan`` body is traced once; every chunk still issues its
collectives.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, List, Set

import torch
import torch.distributed as dist

from repro_torch.kernels.gas_scatter import ops as gas_ops

# the tensor forms of all_gather / reduce_scatter (newer torch names them
# *_single; older only *_tensor — same signature)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class CollectiveCounts:
    """Calls, bytes and logical payload dtypes (``"float32"``,
    ``"int16"``, ...) per collective name; ``counts[name]`` is the calls."""

    def __init__(self):
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.dtypes: Dict[str, Set[str]] = {}

    def __getitem__(self, name: str) -> int:
        return self.calls[name]

    def as_dict(self) -> Dict[str, int]:
        return {k: v for k, v in self.calls.items() if v}


_COUNTERS: List[CollectiveCounts] = []


@contextlib.contextmanager
def count_collectives():
    """Count collective call sites while the context is active. Contexts
    nest: the innermost counter receives the ticks."""
    counts = CollectiveCounts()
    _COUNTERS.append(counts)
    try:
        yield counts
    finally:
        _COUNTERS.remove(counts)


def _tick(name: str, nbytes: int, dtype: torch.dtype) -> None:
    if _COUNTERS and not gas_ops.counting_suspended():
        c = _COUNTERS[-1]
        c.calls[name] += 1
        c.bytes[name] += int(nbytes)
        c.dtypes.setdefault(name, set()).add(
            str(dtype).removeprefix("torch."))


# dtypes gloo or NCCL refuse, shipped as their bytes
_BYTE_VIEW = (torch.int16, torch.bool)


def _flat_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a flat buffer of a dtype every backend ships."""
    flat = x.contiguous().reshape(-1)
    return flat.view(torch.uint8) if x.dtype in _BYTE_VIEW else flat


def _gather(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    # flat buffers: the tensor forms concatenate along dim 0
    flat = _flat_wire(x)
    out = flat.new_empty(mesh.size * flat.numel())
    mesh.run(lambda o, i: _all_gather(o, i, group=mesh.group), out, flat)
    _tick(name, out.nbytes, x.dtype)
    return out.view(x.dtype).reshape((mesh.size,) + tuple(x.shape))


def _scatter_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // mesh.size)
    mesh.run(lambda o, i: _reduce_scatter(o, i, group=mesh.group), out, flat)
    _tick("psum_scatter", flat.nbytes, x.dtype)
    return out.reshape(tuple(x.shape[1:]))


def _exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    # a flat buffer splits into the same n blocks as dim 0 does
    flat = _flat_wire(x)
    out = torch.empty_like(flat)
    mesh.run(lambda o, i: dist.all_to_all_single(o, i, group=mesh.group),
             out, flat)
    _tick("all_to_all", flat.nbytes, x.dtype)
    return out.view(x.dtype).reshape(x.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.suspended = mesh, gas_ops.counting_suspended()
        return _gather(x, mesh, name)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _scatter_sum(g, ctx.mesh), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.suspended = mesh, gas_ops.counting_suspended()
        return _scatter_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _gather(g, ctx.mesh, "all_gather"), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.suspended = mesh, gas_ops.counting_suspended()
        return _exchange(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _exchange(g, ctx.mesh), None


def all_gather(x: torch.Tensor, mesh, *, name: str = "all_gather"
               ) -> torch.Tensor:
    """(…) on every rank → (n, …), rank r's block at [r]. Differentiable
    in a float ``x`` (the backward reduce-scatters the cotangent). ``name``
    is the counter key."""
    return _AllGather.apply(x, mesh, name)


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, …) → (n, …): block [j] goes to rank j, and arrives at [r] from
    rank r. Differentiable (its own transpose)."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all splits dim 0 ({x.shape[0]}) over "
                         f"{mesh.size} ranks")
    return _AllToAll.apply(x, mesh)


def reduce_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, …) → (…): the sum over ranks of block [rank] (JAX's
    ``psum_scatter``). Differentiable (the backward all-gathers the
    cotangent)."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"reduce_scatter splits dim 0 ({x.shape[0]}) over "
                         f"{mesh.size} ranks")
    return _ReduceScatter.apply(x, mesh)


def all_reduce(x: torch.Tensor, mesh, *, name: str = "psum") -> torch.Tensor:
    """The sum of ``x`` over ranks, in a new tensor, with no gradient;
    ``name`` is the counter key."""
    out = x.detach().clone().contiguous()
    mesh.run(lambda o: dist.all_reduce(o, group=mesh.group), out)
    _tick(name, out.nbytes, x.dtype)
    return out
