"""Full-batch training: each step is ``gcn_forward_full`` over the whole
graph, the mean cross-entropy over a seeded training split of the
vertices (labels made from the seed), ``torch.autograd.grad`` through the
port's backward rules, and the port's ``optim.adamw_update``.

Set-up builds one training state (parameters and AdamW's moments) and
drives it through the first ``CHECKED_STEPS`` steps with the window's own
step; the window then goes on with that same state. The reference follows
those first steps from the same starting parameters. Compared: each
step's loss; the first gradient as the optimizer got it (its first moment
after one step, over 1 − beta1), leaf by leaf; and the parameters' change
over the checked steps, leaf by leaf, as the state stands when the window
opens. Each leaf's gap is the gap between the two sides' norms over the
reference's norm of that leaf or of the median leaf, whichever is larger,
and the worst leaf is reported. A leaf whose first reference gradient is
under a thousandth of the median leaf's moves under AdamW by round-off
alone and is left out of the change.
"""

from __future__ import annotations

import math

import torch

from harness import compare, counts, faults, inputs
from reference import gcn as reference
from repro_torch.common.config import TrainConfig
from repro_torch.core import gcn
from repro_torch.optim import adamw

UNIT = "step"
# the steps of set-up that the reference follows
CHECKED_STEPS = 3


class Runner:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.model = cell.config["model"]
        self.hp = dict(cell.traffic["adamw"])
        self.share = float(cell.traffic["train_share"])
        self.losses, self.window_losses = [], []

    def counts(self) -> dict:
        V, E = self.cell.config["vertices"], self.cell.config["edges"]
        w = inputs.widths(self.model)
        H, C = self.model["hidden"], self.model["n_classes"]
        return {"flops": counts.train_flops(V, E, w, H, C),
                "dense_bytes": counts.backward_aggregation_bytes(V, E, w)}

    def setup(self):
        cfg, dev = self.cell.config, self.device
        V = cfg["vertices"]
        self.src, self.dst, self.w = inputs.graph(cfg, self.seed, dev)
        self.x = inputs.tables(1, V, self.model["n_features"], self.seed, dev)
        self.labels, self.train = inputs.labels(
            V, self.model["n_classes"], self.share, self.seed, dev)
        self.p0 = inputs.params(self.model, self.seed, dev)
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in self.p0.items()}
        self.gcfg = gcn.GCNConfig(**self.model)
        self.tc = TrainConfig(**self.hp)
        self.opt = adamw.adamw_init(self.params, self.tc)
        self.edges = inputs.program_edges(self.src, self.dst, self.w, V)

    def _loss(self, logits: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits[self.train], dim=-1)
        return -logp.gather(1, self.labels[self.train][:, None]).mean()

    def _step(self) -> torch.Tensor:
        keys = sorted(self.params)
        logits = gcn.gcn_forward_full(self.params, self.x, *self.edges,
                                      self.gcfg)[0]
        loss = self._loss(logits)
        grads = torch.autograd.grad(loss, [self.params[k] for k in keys])
        adamw.adamw_update(self.params, dict(zip(keys, grads)), self.opt,
                           self.tc)
        return loss.detach()

    def warm(self):
        for k in range(CHECKED_STEPS):
            self.losses.append(self._step())
            if k == 0:
                self.first_grad = first_grad(self.opt["m"], self.hp)
        self.change = change(self.params, self.p0)

    def call(self, i: int):
        self.window_losses.append(self._step())

    def check(self, limits: dict):
        """(the numbers compared, the count of failed answers): a number
        over its limit (each checked step's loss counts apart), or a
        window step whose loss is not finite."""
        del self.edges, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        params = {k: v.clone().requires_grad_(True)
                  for k, v in self.p0.items()}
        opt = reference.AdamW(params, self.hp)
        keys = sorted(params)
        losses = []
        for step in range(len(self.losses)):
            logits = reference.forward(params, self.x[0], self.src, self.dst,
                                       self.w, self.model["n_layers"])
            loss = reference.loss(logits, self.labels, self.train)
            grads = torch.autograd.grad(loss, [params[n] for n in keys])
            del logits
            opt.step(params, dict(zip(keys, grads)))
            losses.append(float(loss.detach()))
            if step == 0:
                want_grad = first_grad(opt.m, self.hp)
        gaps = [compare.rel_gap(float(mine), want)
                for mine, want in zip(self.losses, losses)]
        # leaves that move by round-off alone: their first gradient is
        # nought to rounding next to the median leaf's
        moved = {k for k, g in want_grad.items()
                 if g >= 1e-3 * compare.median(want_grad.values())}
        numbers = {
            "loss_gap": max(gaps),
            "grad_gap": compare.leaf_gap(self.first_grad, want_grad),
            "change_gap": compare.leaf_gap(
                {k: self.change[k] for k in moved},
                {k: v for k, v in change(params, self.p0).items()
                 if k in moved})}
        failed = sum(not g <= limits["loss_gap"] for g in gaps) + sum(
            not numbers[k] <= limits[k] for k in ("grad_gap", "change_gap")
        ) + sum(not math.isfinite(float(x)) for x in self.window_losses)
        return numbers, failed


def first_grad(m: dict, hp: dict) -> dict:
    """Each leaf's norm of the gradient the optimizer got at its first
    step, from its first moment then: m = (1 − beta1) · g."""
    return {k: float(torch.linalg.vector_norm(v.float())) / (1 - hp["beta1"])
            for k, v in m.items()}


def change(params: dict, start: dict) -> dict:
    """Each leaf's norm of its change from ``start``."""
    return {k: float(torch.linalg.vector_norm(
        params[k].detach().float() - start[k].float())) for k in start}


FAULTS = {"stale": (adamw, "adamw_update", faults.frozen_step),
          "half": (Runner, "_loss", faults.half_loss)}
