"""The control of ``correct`` on the card: the program with TF32 on for
its matrix products (the precision below the float32 each configuration
states) fails a cell's limits, and the program as configured passes them,
on three seeds, at the published widths on a 2^14-vertex graph. The same
readings at each cell's own size come from ``perfbench/control.py``."""

import pytest

import control
from _tiny import ROOT, scaled_checkout
from harness import spec

CELLS = ["sage-reddit.full-infer", "sage-reddit.full-train",
         "sage-ogbn100m.full-infer"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_and_the_program_passes(card, cell, tmp_path):
    root = scaled_checkout(tmp_path, 14)
    limits = spec.cell(ROOT, cell).limits
    for seed in (1, 2, 2**31 + 5):
        got = control.reading(root, cell, seed, 2, "cuda")
        assert got["failed"] == 0
        assert all(got[k] <= v for k, v in limits.items()), got
        low = control.reading(root, cell, seed, 2, "cuda", control.tf32)
        assert any(low[k] > v for k, v in limits.items()), low
