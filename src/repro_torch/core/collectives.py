"""The sharded dataflows' collectives, counted.

Every collective of the port goes through this module, over a
``repro_torch.launch.mesh.DataMesh`` or, along one or more of its named
axes (``axis=``, default every axis), a ``Mesh``: ``all_gather`` (into a
tensor), ``all_to_all`` (single), ``all_reduce``, ``reduce_scatter`` and
``ppermute``. Those that carry values into the loss are
``torch.autograd.Function``s with the transposes JAX gives them: the
backward of an ``all_to_all`` is an ``all_to_all``, the backward of an
``all_gather`` a ``reduce_scatter`` and that of a ``reduce_scatter`` (JAX's
``psum_scatter``) an ``all_gather``; a ``psum``'s cotangent is the
cotangent, and ``pvary`` (identity) sums its cotangent; an
``all_gather_invariant``'s backward takes the rank's block; a
``ppermute``'s permutes back. An integer stream (the request ids) carries
no gradient.

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
(``analysis/budgets.py``), and ``table_gather``, the baseline embedding
lookup's gather of the vocab-sharded table, which GSPMD inserts when it
compiles the JAX program. The LM's decode caches in the ``"seq"`` layout
(``models/layers.py``) name theirs: ``cache_relayout`` (the prefill's
all_to_all of its keys and values into sequence slices),
``cache_gather`` (the heads of a replicated ring or cross cache),
``decode_qkv_gather`` (a decode step's one-token q, k, v) and
``decode_max`` / ``decode_sum`` (the flash-decode combine's two
all-reduces); JAX's partitioner moves the same shardings' bytes inside
the program. Counting
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


def _staged_run(mesh, name: str, collective, out, inp, axis) -> None:
    """``mesh.run`` of one collective; what a gloo mesh on the card
    staged for it (calls, bytes, seconds) is also kept under ``name`` in
    ``mesh.staged.by_name``."""
    st = mesh.staged
    calls, nbytes, secs = st.calls, st.bytes, st.seconds
    mesh.run(collective, out, inp, axis=axis)
    if st.calls != calls:
        row = st.by_name.setdefault(name, [0, 0, 0.0])
        row[0] += st.calls - calls
        row[1] += st.bytes - nbytes
        row[2] += st.seconds - secs


# dtypes gloo or NCCL refuse, shipped as their bytes
_BYTE_VIEW = (torch.int16, torch.bool)


def _flat_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a flat buffer of a dtype every backend ships."""
    flat = x.contiguous().reshape(-1)
    return flat.view(torch.uint8) if x.dtype in _BYTE_VIEW else flat


def _gather(x: torch.Tensor, mesh, name: str, axis=None) -> torch.Tensor:
    # flat buffers: the tensor forms concatenate along dim 0
    _, n = mesh.line(axis)
    flat = _flat_wire(x)
    out = flat.new_empty(n * flat.numel())
    _staged_run(mesh, name, lambda o, i, g: _all_gather(o, i, group=g),
                out, flat, axis)
    _tick(name, out.nbytes, x.dtype)
    return out.view(x.dtype).reshape((n,) + tuple(x.shape))


def _scatter_sum(x: torch.Tensor, mesh, axis=None) -> torch.Tensor:
    _, n = mesh.line(axis)
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // n)
    _staged_run(mesh, "psum_scatter",
                lambda o, i, g: _reduce_scatter(o, i, group=g), out, flat,
                axis)
    _tick("psum_scatter", flat.nbytes, x.dtype)
    return out.reshape(tuple(x.shape[1:]))


def _exchange(x: torch.Tensor, mesh, axis=None,
              name: str = "all_to_all") -> torch.Tensor:
    # a flat buffer splits into the same n blocks as dim 0 does
    flat = _flat_wire(x)
    out = torch.empty_like(flat)
    _staged_run(mesh, name,
                lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                out, flat, axis)
    _tick(name, flat.nbytes, x.dtype)
    return out.view(x.dtype).reshape(x.shape)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _reduce(x: torch.Tensor, mesh, name: str, axis=None,
            op: str = "sum") -> torch.Tensor:
    out = x.detach().clone().contiguous()
    _staged_run(mesh, name,
                lambda o, g: dist.all_reduce(o, op=_REDUCE_OPS[op], group=g),
                out, None, axis)
    _tick(name, out.nbytes, x.dtype)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.suspended = gas_ops.counting_suspended()
        return _gather(x, mesh, name, axis)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _scatter_sum(g, ctx.mesh, ctx.axis), None, None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, axis):
        ctx.index = mesh.axis_index(axis)
        return _gather(x, mesh, name, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.suspended = gas_ops.counting_suspended()
        return _scatter_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _gather(g, ctx.mesh, "all_gather", ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, name):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.suspended = gas_ops.counting_suspended()
        return _exchange(x, mesh, axis, name)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _exchange(g, ctx.mesh, ctx.axis), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, axis):
        return _reduce(x, mesh, name, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.suspended = gas_ops.counting_suspended()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with gas_ops.suspend_counting(ctx.suspended):
            return _reduce(g, ctx.mesh, "psum", ctx.axis), None, None


def _p2p(out: torch.Tensor, inp: torch.Tensor, group, sends, recvs):
    ops = [dist.P2POp(dist.isend, inp, dist.get_global_rank(group, d),
                      group) for d in sends]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s),
                       group) for s in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _permute(x: torch.Tensor, mesh, axis, perm) -> torch.Tensor:
    me = mesh.axis_index(axis)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    flat = _flat_wire(x)
    out = torch.zeros_like(flat)
    _staged_run(mesh, "ppermute",
                lambda o, i, g: _p2p(o, i, g, sends, recvs), out, flat,
                axis)
    _tick("ppermute", flat.nbytes, x.dtype)
    return out.view(x.dtype).reshape(x.shape)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        ctx.suspended = gas_ops.counting_suspended()
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        with gas_ops.suspend_counting(ctx.suspended):
            return _permute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def all_gather(x: torch.Tensor, mesh, *, name: str = "all_gather",
               axis=None) -> torch.Tensor:
    """(…) on every rank → (n, …), the block of the rank at index i along
    ``axis`` (default: every axis of the mesh) at [i]. Differentiable in a
    float ``x``: the backward reduce-scatters the cotangent (each rank's
    cotangent a partial sum, as of rows only it ran). ``name`` is the
    counter key."""
    return _AllGather.apply(x, mesh, name, axis)


def all_gather_invariant(x: torch.Tensor, mesh, *,
                         name: str = "all_gather", axis=None
                         ) -> torch.Tensor:
    """``all_gather`` for a compute every rank of ``axis`` then repeats
    on the same values (JAX's ``all_gather_invariant``): the cotangent is
    the same on every rank, and the backward takes this rank's block of
    it, with no collective."""
    return _AllGatherInvariant.apply(x, mesh, name, axis)


def all_to_all(x: torch.Tensor, mesh, *, axis=None,
               name: str = "all_to_all") -> torch.Tensor:
    """(n, …) → (n, …): block [j] goes to rank j, and arrives at [r] from
    rank r. Differentiable (its own transpose). ``name`` is the counter
    key."""
    _, n = mesh.line(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all splits dim 0 ({x.shape[0]}) over "
                         f"{n} ranks")
    return _AllToAll.apply(x, mesh, axis, name)


def reduce_scatter(x: torch.Tensor, mesh, *, axis=None) -> torch.Tensor:
    """(n, …) → (…): the sum over ranks of block [rank] (JAX's
    ``psum_scatter``). Differentiable (the backward all-gathers the
    cotangent)."""
    _, n = mesh.line(axis)
    if x.shape[0] != n:
        raise ValueError(f"reduce_scatter splits dim 0 ({x.shape[0]}) over "
                         f"{n} ranks")
    return _ReduceScatter.apply(x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh, *, name: str = "psum", axis=None,
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"`` / ``"min"``) of ``x`` over the ranks of
    ``axis``, in a new tensor, with no gradient; ``name`` is the counter
    key."""
    return _reduce(x, mesh, name, axis, op)


def psum(x: torch.Tensor, mesh, *, axis=None, name: str = "psum"
         ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable: the
    cotangent of the sum is every addend's cotangent (JAX's psum
    transpose), with no collective in the backward."""
    return _Psum.apply(x, mesh, name, axis)


def pvary(x: torch.Tensor, mesh, *, axis=None) -> torch.Tensor:
    """``x`` unchanged, entering a compute that differs across the ranks
    of ``axis`` (JAX's ``pvary``): each rank's cotangent covers its own
    part, so the backward sums them (one ``psum``)."""
    return _Pvary.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, *, axis, perm) -> torch.Tensor:
    """JAX's ``ppermute`` along ``axis``: for each ``(src, dst)`` of
    ``perm`` (indices along the axis) rank ``src``'s ``x`` arrives at
    ``dst``; a rank nothing is sent to gets zeros. Differentiable (the
    backward permutes the cotangent back)."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Ppermute.apply(x, mesh, axis, perm)
