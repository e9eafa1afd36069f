"""The numbers that decide ``correct``, each a gap between the program's
answer and the plain reference's, as a share of the reference's scale."""

from __future__ import annotations

import math

import torch


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of ``got`` from ``want`` (both (V, C)), per row as a
    share of that row's largest |reference logit| or of the median row's,
    whichever is larger (a row whose logits are all but zero would
    otherwise read rounding as a fault). A non-finite answer reads inf."""
    got = got.to(torch.float32)
    want = want.to(torch.float32)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    scale = want.abs().amax(dim=1)
    denom = torch.clamp(scale, min=float(scale.median()))
    return float(((got - want).abs().amax(dim=1) / denom).max())


def rel_gap(got: float, want: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def median(values) -> float:
    """The median leaf's value: the lower middle one for an even count,
    so that it is a leaf's own."""
    v = sorted(values)
    return v[(len(v) - 1) // 2]


def leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's gap between two norms of each leaf (``got`` the
    program's, ``want`` the reference's), each over the reference's norm
    of that leaf or of the median leaf, whichever is larger. A leaf the
    program lacks or gives as not finite reads inf."""
    if not want:
        return 0.0
    if set(got) != set(want) or not all(map(math.isfinite, got.values())):
        return math.inf
    scale = max(median(want.values()), 1e-30)
    return max(abs(got[k] - w) / max(w, scale) for k, w in want.items())
