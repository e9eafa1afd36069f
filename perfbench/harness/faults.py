"""Faults planted under the timed path, to show that ``correct`` catches
them: each patches the program (or the entry's own step) while a run's
set-up, warm calls and window run. Each entry lists the faults its cells
can have in its ``FAULTS``.

* ``stale`` — a call that returns its state unchanged: a forward that
  hands back its first answer again; a training step whose optimizer
  leaves the parameters as they were.
* ``half`` — half of the batch left out: a forward that aggregates over
  the first half of the edges only; a loss that is the mean over the first
  half of the training vertices.
* ``altered`` — an answer altered where it is produced: one vertex's
  logits scaled by 1.01.

On one chip no exchange between chips exists to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, fn):
    old = getattr(owner, name)
    setattr(owner, name, fn(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def stale_forward(old):
    first = []

    def fn(*args, **kwargs):
        out = old(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    return fn


def half_edges(old):
    def fn(params, feats, src, dst, w, mask, cfg, **kwargs):
        cut = mask.clone()
        cut[:, mask.shape[1] // 2:] = False
        return old(params, feats, src, dst, w, cut, cfg, **kwargs)
    return fn


def altered(old):
    def fn(*args, **kwargs):
        out = old(*args, **kwargs).clone()
        out[:, out.shape[1] // 3] *= 1.01
        return out
    return fn


def frozen_step(old):
    def fn(params, grads, opt_state, tc, **kwargs):
        return params, opt_state, {}
    return fn


def half_loss(old):
    def fn(self, logits):
        keep = self.train[: self.train.shape[0] // 2]
        logp = torch.log_softmax(logits[keep], dim=-1)
        return -logp.gather(1, self.labels[keep][:, None]).mean()
    return fn


def plant(entry, fault: str):
    """The context that plants ``fault`` under ``entry`` (a module of
    ``perfbench/entries``, whose ``FAULTS`` maps each fault its cells can
    have to the (owner, attribute, patch) that plants it)."""
    owner, name, patch = entry.FAULTS[fault]
    return _patched(owner, name, patch)
