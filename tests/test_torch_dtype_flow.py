"""Port parity: the dtype rules over counted runs (``analysis/dtype_flow``).

Planted runs on 2 CPU gloo ranks (one spawn for the file): float64 on the
wire, unsigned ids on the wire, an unwaived bf16 ``all_to_all`` and a bf16
reduce-scatter are flagged; the bf16 and int8 compressed wires are silent
under their contracts' ``narrow-wire`` waiver, and their int16 delta ids
(shipped as ``uint8`` bytes) are recorded as int16 and never read as an
unsigned wire. A float64 table at a GAS entry is flagged. uint32 never
reaches a wire here (gloo refuses it), so that case is checked on a
recorded run. An unknown waiver raises. The JAX rules' own fixtures
(``tests/test_analysis.py``) flag the same four kinds of trace.
"""

import sys

import pytest
import torch

from repro_torch.analysis import dtype_flow as D
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.counts import RunCounts

torch.set_num_threads(1)

TIMEOUT_S = 300
P, PART, F, B, K = 2, 16, 8, 4, 3


def _rules(issues):
    return sorted({(i.rule, i.primitive) for i in issues})


def _dtype_rank(mesh):
    from repro_torch.core import cgtrans
    from repro_torch.core import collectives as col
    from repro_torch.launch.counts import count_run

    g = torch.Generator().manual_seed(mesh.rank)
    feats = torch.randint(-4, 5, (1, PART, F), generator=g).float()
    nbrs = torch.randint(0, P * PART, (1, B, K), generator=g,
                         dtype=torch.int32)
    mask = torch.ones((1, B, K), dtype=torch.bool)
    runs = {
        "f64_wire": count_run(lambda: col.all_to_all(
            torch.ones(P, 3, dtype=torch.float64), mesh)),
        "uint8_ids": count_run(lambda: col.all_gather(
            nbrs.reshape(-1).to(torch.uint8), mesh)),
        "bf16_a2a": count_run(lambda: col.all_to_all(
            torch.ones(P, 3, dtype=torch.bfloat16), mesh)),
        "bf16_reduce_scatter": count_run(lambda: col.reduce_scatter(
            torch.ones(P, 3, dtype=torch.bfloat16), mesh)),
        "f64_table": count_run(lambda: cgtrans.aggregate_sampled(
            feats.double(), nbrs, mask, mesh=mesh)),
    }
    for wire in ("f32", "bf16", "int8"):
        runs[f"wire_{wire}"] = count_run(
            lambda f: cgtrans.aggregate_sampled(f, nbrs, mask, mesh=mesh,
                                                wire=wire), feats,
            fwd_bwd=True)
    for k, run in runs.items():
        runs[k] = dict(dtypes=run.dtypes, entries=run.entries,
                       calls=run.calls)
    runs["modules"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return runs


@pytest.fixture(scope="module")
def runs():
    ranks = meshlib.spawn(_dtype_rank, P, backend="gloo", device="cpu",
                          timeout_s=TIMEOUT_S)
    assert all(r["modules"] == [] for r in ranks)
    return ranks


def _run(rank, name):
    return RunCounts(calls=rank[name]["calls"], bytes={},
                     dtypes=rank[name]["dtypes"], dispatches={},
                     entries=rank[name]["entries"])


@pytest.mark.parametrize("name,want", [
    ("f64_wire", [("f64", "all_to_all")]),
    ("uint8_ids", [("narrow-wire", "all_gather"),
                   ("unsigned-wire", "all_gather")]),
    ("bf16_a2a", [("narrow-wire", "all_to_all")]),
    ("bf16_reduce_scatter", [("accum", "psum_scatter"),
                             ("narrow-wire", "psum_scatter")]),
    ("f64_table", [("f64", "all_to_all"), ("f64", "entry find"),
                   ("f64", "entry reduce")]),
])
def test_planted_payload_is_flagged(runs, name, want):
    for rank in runs:
        assert _rules(D.check_dtype_flow(_run(rank, name))) == want


def test_uint32_ids_on_the_wire_are_flagged():
    run = RunCounts(calls={"all_gather": 1}, bytes={},
                    dtypes={"all_gather": {"uint32"}}, dispatches={},
                    entries={})
    assert _rules(D.check_dtype_flow(run)) == [("unsigned-wire",
                                                "all_gather")]


def test_accum_waiver_silences_only_accum(runs):
    run = _run(runs[0], "bf16_reduce_scatter")
    assert _rules(D.check_dtype_flow(run, waive=("accum",))) == [
        ("narrow-wire", "psum_scatter")]


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_compressed_wire_is_silent_under_its_waiver(runs, wire):
    for rank in runs:
        run = _run(rank, f"wire_{wire}")
        assert D.check_dtype_flow(run, waive=("narrow-wire",)) == []
        # unwaived, only the declared narrowness shows: never an unsigned
        # wire, though the int16 ids ship as their uint8 bytes
        assert {i.rule for i in D.check_dtype_flow(run)} == {"narrow-wire"}


def test_delta_ids_are_recorded_as_int16(runs):
    for rank in runs:
        assert rank["wire_bf16"]["dtypes"]["all_gather"] == {"int16"}
        assert rank["wire_int8"]["dtypes"]["all_gather"] == {"int16"}
        assert rank["wire_f32"]["dtypes"]["all_gather"] == {"int32"}


def test_f32_wire_is_silent(runs):
    for rank in runs:
        run = _run(rank, "wire_f32")
        assert D.check_dtype_flow(run) == []
        assert run.entries["find"] == {"float32"}


def test_unknown_waiver_raises():
    run = RunCounts(calls={}, bytes={}, dtypes={}, dispatches={}, entries={})
    with pytest.raises(ValueError, match="unknown dtype rule"):
        D.check_dtype_flow(run, waive=("narrow_wire",))


def test_issue_reads_as_the_reference_issue():
    issue = D.DtypeIssue("narrow-wire", "all_to_all", "bfloat16 payload")
    assert str(issue) == "[narrow-wire] all_to_all: bfloat16 payload"
    from repro.analysis.dtype_flow import RULES
    assert D.RULES == RULES
