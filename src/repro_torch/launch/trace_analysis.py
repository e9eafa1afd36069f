"""What one run of a function costs, counted op by op as it runs.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
JAX reads its numbers off the optimised HLO of a compiled program; the
port has no compiled program, so ``analyze`` runs the function once under
a ``TorchDispatchMode`` of its own that sees every aten op, forward and
backward, and reads what the op was given and returned. It works the same
on real tensors and on fake ones (``torch._subclasses.fake_tensor``), which
is how ``launch/dryrun.py`` traces a production rank's step with no card
and no memory: the numbers depend on shapes and dtypes only, never on
values.

* **dot FLOPs**: the formulas ``torch.utils.flop_counter`` registers for
  the matrix ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolution,
  attention), 2 · M · N · K each — JAX's dot count.
* **HBM bytes**, an eager, unfused upper bound: a view (an op whose output
  aliases its input, ``OpOverload.is_view``) moves nothing; every other op
  reads each tensor it is given once and writes each tensor it returns
  once, each at its own size (a view's elements, not its base's). An
  in-place op writes the argument it mutates, and ``copy_``, ``fill_``,
  ``zero_`` and an ``out=`` argument are written without being read, so an
  in-place write into a slice (a decode step's cache slot) moves the slice
  only. A gather reads the whole tensor it indexes, as the JAX model
  charges a gather's operands; kernels the eager run would fuse count
  each of their ops.
* **peak bytes**: the most bytes of live tensor storage at any moment,
  counting the arguments as live throughout (the caller holds them) and a
  storage from the op that creates it until its last tensor dies. Each
  storage counts in blocks of ``ALLOC_BLOCK`` bytes, as the CUDA caching
  allocator rounds a request. Every tensor of the function is taken to
  live on the one device it runs on. Storage a kernel allocates for itself
  and frees before it returns (a library's workspace) is not seen.
* **collectives**: calls and bytes per name from
  ``core.collectives.count_collectives``.

``ops`` is the per-op table: calls, bytes and FLOPs per aten op.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import collectives

#: the CUDA caching allocator's block: every request is rounded up to it
ALLOC_BLOCK = 512

_aten = torch.ops.aten
#: in-place ops that overwrite their first argument without reading it
_OVERWRITES = frozenset({_aten.copy_, _aten.fill_, _aten.zero_})


@dataclasses.dataclass
class TraceSummary:
    dot_flops: float
    hbm_bytes: float
    peak_bytes: int        # the most live storage, arguments included
    args_bytes: int        # the arguments' storage
    collectives: Dict[str, Dict[str, float]]   # name -> {count, bytes}
    ops: Dict[str, Dict[str, float]]   # aten op -> {calls, bytes, flops}


def _block(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Live:
    """Live storage bytes and their peak. A storage is seen once, from the
    first tensor on it, and leaves when its Python object (kept as long as
    the storage lives) is collected."""

    def __init__(self):
        self.bytes = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        size = _block(st.nbytes())

        def gone(_, key=key, size=size):
            self._refs.pop(key, None)
            self.bytes -= size

        self._refs[key] = weakref.ref(st, gone)
        self.bytes += size
        self.peak = max(self.peak, self.bytes)


class _Counter(TorchDispatchMode):
    """Counts every aten op that reaches it: FLOPs, bytes and the storage
    its outputs bring to life."""

    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: Dict[str, Dict[str, float]] = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0.0, "flops": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out        # a fake tensor's device query, not an op
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        moved = 0.0 if func.is_view else self._moved(func, args, kwargs,
                                                      out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.live.add(t)
        row = self.ops[packet.__name__]
        row["calls"] += 1
        row["bytes"] += moved
        row["flops"] += flops
        self.flops += flops
        self.bytes += moved
        return out

    @staticmethod
    def _moved(func, args, kwargs, out) -> float:
        """Bytes read and written by one op that is not a view."""
        schema = func._schema
        if not schema.is_mutable:
            read = [t for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)]
            written = [t for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)]
            return float(sum(map(_nbytes, read)) + sum(map(_nbytes, written)))
        given = dict(zip((a.name for a in schema.arguments), args))
        given.update(kwargs)
        read, written = [], []
        for a in schema.arguments:
            v = given.get(a.name)
            tensors = [t for t in tree_leaves(v)
                       if isinstance(t, torch.Tensor)]
            if a.alias_info is not None and a.alias_info.is_write:
                written += tensors
                if a.kwarg_only or func._overloadpacket in _OVERWRITES:
                    continue          # out= and wholesale overwrites
            read += tensors
        return float(sum(map(_nbytes, read)) + sum(map(_nbytes, written)))


def analyze(fn: Callable, *args, **kwargs) -> TraceSummary:
    """Run ``fn(*args, **kwargs)`` once and count it. Under a
    ``FakeTensorMode`` with fake arguments nothing is computed or
    allocated: the counts are what a real run of the same shapes issues
    (``tests/test_torch_dryrun.py`` holds the two equal)."""
    live = _Live()
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            live.add(t)
    args_bytes = live.bytes
    counter = _Counter(live)
    with collectives.count_collectives() as c, counter:
        fn(*args, **kwargs)
    colls = {k: {"count": float(c.calls[k]), "bytes": float(c.bytes[k])}
             for k in sorted(c.calls) if c.calls[k]}
    ops = {k: dict(v) for k, v in sorted(counter.ops.items(),
                                         key=lambda kv: -kv[1]["bytes"])}
    return TraceSummary(dot_flops=counter.flops, hbm_bytes=counter.bytes,
                        peak_bytes=live.peak, args_bytes=args_bytes,
                        collectives=colls, ops=ops)
