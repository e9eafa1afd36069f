"""Full-graph inference: back-to-back ``gcn_forward_full`` calls, one in
flight, over a graph and parameters fixed for the run.

The forwards alternate between ``tables`` feature tables made from the
seed, so no forward's answer can be reused for the next. A seeded
reservoir keeps ``RETAIN`` of the window's answers, and the last one
always; once the window has closed and the program's state is freed, each
kept answer is held against the plain reference's logits for its table.
"""

from __future__ import annotations

import random

import torch

from harness import compare, counts, faults, inputs
from reference import gcn as reference
from repro_torch.core import gcn

UNIT = "forward"
# the window's answers that a seeded reservoir keeps for the check
RETAIN = 3


class Runner:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.model = cell.config["model"]
        self.n_tables = int(cell.traffic["tables"])
        self.kept = []          # (forward index, table, logits)
        self.last = None
        self.pick = random.Random(seed)

    def counts(self) -> dict:
        V, E = self.cell.config["vertices"], self.cell.config["edges"]
        w = inputs.widths(self.model)
        H, C = self.model["hidden"], self.model["n_classes"]
        return {"flops": counts.forward_flops(V, E, w, H, C),
                "banded_bytes": counts.forward_aggregation_bytes(V, E, w)}

    def setup(self):
        cfg, dev = self.cell.config, self.device
        V = cfg["vertices"]
        self.src, self.dst, self.w = inputs.graph(cfg, self.seed, dev)
        self.tables = inputs.tables(self.n_tables, V, self.model["n_features"],
                                    self.seed, dev)
        self.params = inputs.params(self.model, self.seed, dev)
        self.gcfg = gcn.GCNConfig(**self.model)
        self.edges = inputs.program_edges(self.src, self.dst, self.w, V)

    def _forward(self, t: int) -> torch.Tensor:
        with torch.no_grad():
            return gcn.gcn_forward_full(self.params, self.tables[t:t + 1],
                                        *self.edges, self.gcfg)

    def warm(self):
        # every table's forward (the first builds the kernels), held at
        # once as often as the window holds answers (the kept ones, the
        # last and the one in flight), so that the allocator's pool has
        # their blocks before the window opens
        held = [self._forward(i % self.n_tables)
                for i in range(max(RETAIN + 2, self.n_tables))]
        del held

    def call(self, i: int):
        t = i % self.n_tables
        out = self._forward(t)
        self.last = (i, t, out)
        # reservoir sampling: every forward of the window equally likely
        if len(self.kept) < RETAIN:
            self.kept.append(self.last)
        else:
            j = self.pick.randrange(i + 1)
            if j < RETAIN:
                self.kept[j] = self.last

    def check(self, limits: dict):
        """(the numbers compared, the count of failed answers): the widest
        gap of a kept answer, and the kept answers whose gap passes the
        limit."""
        kept = {i: (t, out) for i, t, out in self.kept}
        if self.last is not None:
            kept[self.last[0]] = self.last[1:]
        del self.edges, self.kept, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want = {}
        with torch.no_grad():
            for t in sorted({t for t, _ in kept.values()}):
                want[t] = reference.forward(self.params, self.tables[t],
                                            self.src, self.dst, self.w,
                                            self.model["n_layers"])
            gaps = [compare.row_gap(out[0], want[t])
                    for t, out in kept.values()]
        failed = sum(not g <= limits["logit_gap"] for g in gaps)
        return {"logit_gap": max(gaps, default=float("inf"))}, failed


FAULTS = {"stale": (gcn, "gcn_forward_full", faults.stale_forward),
          "half": (gcn, "gcn_forward_full", faults.half_edges),
          "altered": (gcn, "gcn_forward_full", faults.altered)}
