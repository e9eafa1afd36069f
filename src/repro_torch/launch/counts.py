"""Count what one run of a dataflow issues: collectives, GAS dispatches
and the dtypes they carry.

The counterpart of the JAX package's ``launch/jaxpr_stats``. JAX counts
the primitives of a traced program; the port has no trace, so
``count_run`` runs the function once under ``count_collectives()``,
``gas.count_dispatches()`` and ``kernels.entries.record()`` and reads what
was called. The JAX tool counts **static sites** (a ``lax.scan`` body
once); the port counts **call sites** as they run, with a chunk loop's
later passes suspended (``cgtrans.scan_request_chunks``), so its body
also counts once. The contract builders (``analysis/contracts.py``) run
unchunked, where both counts are the same by construction; a chunked
run's collectives are ``budgets.chunked_fetch_collectives`` of its
segments.

Collective keys are the JAX primitives' canonical names
(``COLLECTIVE_PRIMITIVES``); the collectives JAX issues outside its traced
program carry keys of their own (``OUTSIDE_KEYS``, see
``core/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Set

import torch

from repro_torch.analysis import budgets
from repro_torch.common.tree import leaves, tree_map
from repro_torch.core import collectives, gas
from repro_torch.kernels import entries

#: the cross-shard collectives of the CGTrans dataflows by canonical JAX
#: name: ``psum`` is ``all_reduce`` and ``psum_scatter`` ``reduce_scatter``
COLLECTIVE_PRIMITIVES = budgets.COLLECTIVE_KEYS

#: the collectives JAX issues outside its traced program (GSPMD's gradient
#: reduction, the metrics, the host reading a sharded result, the serving
#: trigger, the island un-permute, the baseline lookup's table gather),
#: counted under names of their own
OUTSIDE_KEYS = ("grad_all_reduce", "metric_all_reduce", "result_gather",
                "trigger_broadcast", "relabel_gather", "table_gather")

DISPATCH_KEYS = budgets.DISPATCH_KEYS


@dataclasses.dataclass
class RunCounts:
    """One run's counts: collective ``calls``, ``bytes`` and logical
    payload ``dtypes`` per collective name, GAS ``dispatches`` per kind,
    the dtypes at each kernel ``entries`` kind, and the run's ``output``."""
    calls: Dict[str, int]
    bytes: Dict[str, int]
    dtypes: Dict[str, Set[str]]
    dispatches: Dict[str, int]
    entries: Dict[str, Set[str]]
    output: Any = None

    def as_dict(self) -> Dict[str, int]:
        """Every nonzero count, collectives and dispatches in one dict (the
        form ``analysis/budgets.py``'s tables take)."""
        return {**{k: v for k, v in self.calls.items() if v},
                **{k: v for k, v in self.dispatches.items() if v}}


def _floating(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def scalarize(out) -> torch.Tensor:
    """The sum of every floating output leaf, in f32 — the scalar the
    forward + backward differentiates (JAX's ``_scalarize``)."""
    floats = [x for x in leaves(out) if _floating(x)]
    if not floats:
        raise ValueError("no floating output to differentiate")
    return sum(x.to(torch.float32).sum() for x in floats)


def count_run(fn: Callable, *args, fwd_bwd: bool = False) -> RunCounts:
    """Run ``fn(*args)`` once and count it. With ``fwd_bwd=True`` the
    floating outputs are summed to one f32 scalar (``scalarize``) and the
    backward runs with respect to ``args[0]`` (every floating leaf of it),
    inside the same counters."""
    if fwd_bwd:
        # every floating leaf of args[0] a fresh leaf that needs a gradient
        args = (tree_map(lambda x: x.detach().clone().requires_grad_(True)
                         if _floating(x) else x, args[0]),) + tuple(args[1:])
    with collectives.count_collectives() as c, \
            gas.count_dispatches() as d, entries.record() as e:
        out = fn(*args)
        if fwd_bwd:
            scalarize(out).backward()
    return RunCounts(calls=dict(c.calls), bytes=dict(c.bytes),
                     dtypes={k: set(v) for k, v in c.dtypes.items()},
                     dispatches={k: d[k] for k in DISPATCH_KEYS},
                     entries={k: set(v) for k, v in e.items()}, output=out)
