"""MoE: device ms per training step of the routed expert layer's three
spans, ``moe.route`` (router, top-k, balance loss), ``moe.experts`` and
``moe.combine`` (each token's weighted sum of its slots' rows), forward and
recomputation; nothing where any of the three recorded nothing."""

from harness import spans

ROOT = "lm.loss"      # opened once per step by loss_fn
SPANS = ("moe.route", "moe.experts", "moe.combine")


def read(ctx):
    parts = [spans.span_ms(ctx, "step", name, ROOT) for name in SPANS]
    return None if None in parts else sum(parts)
