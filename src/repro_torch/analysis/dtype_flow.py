"""Dtype-flow checks over one counted run (the semantic half of the lint).

The JAX package walks a traced jaxpr; the port reads what
``launch.counts.count_run`` recorded: the logical payload dtypes of every
collective (before ``core/collectives.py`` ships an int16 or bool payload
as its ``uint8`` bytes) and the dtypes at every GAS and flash entry
(``kernels/entries.py``). The same four rules:

* ``f64`` — no float64 anywhere: on a collective or at a kernel entry a
  float64 payload means an accidental promotion (a numpy float64 crossing
  into a tensor) that doubles every byte the collective counts report.
* ``accum`` — sums accumulate in f32: a ``psum`` / ``psum_scatter`` (or
  another ``all_reduce`` key) over a bf16 or f16 payload sums in the
  narrow type. The compressed wire ships narrow partials over an
  ``all_to_all`` and sums them in f32 on arrival, which this rule allows.
* ``unsigned-wire`` — the id and request streams are signed end to end
  (the ``-1`` dead-id encoding): an unsigned logical dtype entering a
  collective means a cast re-encoded ``-1`` as 2³²−1. The ``uint8`` view
  a backend ships int16 and bool payloads as is not a logical dtype and
  is not flagged.
* ``narrow-wire`` — a payload under 32 bits on a collective (bf16 / f16
  partials, int8 codes, int16 delta ids) is a lossy or re-encoded
  transport and must be declared: a contract whose dataflow compresses
  its wire carries ``dtype_waivers=("narrow-wire",)``. Bools are exempt
  (the baseline's ownership masks).

``check_dtype_flow`` returns a list of ``DtypeIssue``; an unknown waiver
raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

#: every rule this module can emit (contracts reference these in waivers)
RULES = ("f64", "accum", "unsigned-wire", "narrow-wire")

#: the counter keys of collectives that sum their payload (``all_reduce``
#: under each of its names, and the reduce-scatter)
SUM_COLLECTIVES = ("psum", "psum_scatter", "grad_all_reduce",
                   "metric_all_reduce", "trigger_broadcast")

_NARROW_FLOATS = ("bfloat16", "float16")
_UNSIGNED = ("uint8", "uint16", "uint32", "uint64")
_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
             "bfloat16": 2, "float16": 2, "float8_e4m3fn": 1,
             "float8_e5m2": 1}
_F64 = "float64"  # lint: allow(f64-literal): the rule that bans it must name it


@dataclasses.dataclass(frozen=True)
class DtypeIssue:
    rule: str           # one of RULES
    primitive: str      # the collective's counter key, or "entry <kind>"
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.primitive}: {self.detail}"


def validate_waivers(waive: Sequence[str]) -> frozenset:
    waived = frozenset(waive)
    for w in waived:
        if w not in RULES:
            raise ValueError(f"unknown dtype rule {w!r} (have {RULES})")
    return waived


def _narrow(dtype: str) -> bool:
    return dtype != "bool" and _ITEMSIZE.get(dtype, 4) < 4


def check_dtype_flow(run, *, waive: Sequence[str] = ()) -> List[DtypeIssue]:
    """All dtype-flow issues of one counted run (``launch.counts.RunCounts``
    or anything with its ``dtypes`` and ``entries`` mappings). ``waive``
    drops the named rules — contracts use it to document intentional
    exceptions (narrow transport)."""
    waived = validate_waivers(waive)
    issues: List[DtypeIssue] = []
    for name in sorted(run.dtypes):
        dts = sorted(run.dtypes[name])
        if "f64" not in waived and _F64 in dts:
            issues.append(DtypeIssue(
                "f64", name, "float64 payload on the wire (f32-accumulation "
                "stack — find the promotion)"))
        if "accum" not in waived and name in SUM_COLLECTIVES:
            for dt in dts:
                if dt in _NARROW_FLOATS:
                    issues.append(DtypeIssue(
                        "accum", name, f"sum over {dt} accumulates in {dt}, "
                        f"not f32"))
                    break
        if "unsigned-wire" not in waived:
            for dt in dts:
                if dt in _UNSIGNED:
                    issues.append(DtypeIssue(
                        "unsigned-wire", name, f"{dt} id/payload stream on "
                        f"the wire — the -1 mask encoding needs signed "
                        f"ints"))
                    break
        if "narrow-wire" not in waived:
            for dt in dts:
                if _narrow(dt):
                    issues.append(DtypeIssue(
                        "narrow-wire", name, f"{dt} payload on the wire — "
                        f"narrow transport must be declared via a "
                        f"dtype_waivers=('narrow-wire',) contract"))
                    break
    if "f64" not in waived:
        for kind in sorted(run.entries):
            if _F64 in run.entries[kind]:
                issues.append(DtypeIssue(
                    "f64", f"entry {kind}", "float64 tensor at a kernel "
                    "entry (f32-accumulation stack — find the promotion)"))
    return issues
