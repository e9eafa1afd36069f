"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have (``harness.faults``), planted in a whole run
on the CPU at a tiny size (the look for a card skipped); a sound run of
each cell reads true."""

import pytest

import run
from _tiny import ROOT, tiny_checkout
from harness import faults, spec

CELLS = ["sage-reddit.full-infer", "sage-reddit.full-train",
         "sage-ogbn100m.full-infer"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, cell, trace=False):
    return run.run_cell(root, cell, 2**31 + 3, 0.1, trace, "cpu",
                        setup_clock=lambda: 1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in spec.entry_module(spec.cell(ROOT, c)).FAULTS])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    entry = spec.entry_module(spec.cell(root, cell))
    with faults.plant(entry, fault):
        out = _run(root, cell)
    assert not out["correct"], (fault, out["checks"])
