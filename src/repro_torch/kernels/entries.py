"""The dtypes that enter the GAS and flash entry points.

While a ``record()`` context is active, each entry notes the dtypes of the
tensors it was given under its kind (``find``, ``reduce``,
``kernel_scatter``, ``flash``), on both routes: the plain version's entry
and the kernel's. ``launch/counts.py`` records a run with it and
``analysis/dtype_flow.py`` reads the result (a float64 payload has no
business at a kernel entry).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set

import torch

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
