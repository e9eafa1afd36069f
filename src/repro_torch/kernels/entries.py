"""The dtypes that enter the GAS and flash entry points.

While a ``record()`` context is active, each entry notes the dtypes of the
tensors it was given under its kind (``find``, ``reduce``,
``kernel_scatter``, ``flash``), on both routes: the plain version's entry
and the kernel's. ``launch/counts.py`` records a run with it and
``analysis/dtype_flow.py`` reads the result (a float64 payload has no
business at a kernel entry).

``refuse_fake`` is every kernel wrapper's first check: a kernel reads
memory, and a fake tensor (``torch._subclasses.fake_tensor``, what
``launch/dryrun.py`` traces) has none, so the wrapper raises before it
builds, binds or runs anything, and never falls back to the plain version.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: why a kernel wrapper refuses a fake tensor
FAKE_TENSOR_RULE = (
    "a kernel launches on tensors with memory, and a fake tensor has none: "
    "the dry run (launch/dryrun.py) traces the JAX dry run's defaults, "
    "impl='ref' and use_flash=False, which launch no kernel")

_RECORDS: List[Dict[str, Set[str]]] = []


@contextlib.contextmanager
def record():
    """Record entry dtypes while active: yields ``{kind: {dtype name}}``.
    Contexts nest: the innermost record receives the notes."""
    rec: Dict[str, Set[str]] = {}
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def note(kind: str, *tensors: Optional[torch.Tensor]) -> None:
    if _RECORDS:
        names = _RECORDS[-1].setdefault(kind, set())
        names.update(str(t.dtype).removeprefix("torch.")
                     for t in tensors if t is not None)


def refuse_fake(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if any of ``tensors`` is a fake tensor."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise NotImplementedError(f"{kernel} on a fake tensor: "
                                  f"{FAKE_TENSOR_RULE}")
