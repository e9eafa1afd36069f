"""MoE: device ms per training step of the ``moe.experts`` spans, the
dropless dispatch (the slots' sort by expert and the gather of their rows)
and the held experts' grouped GEMMs, forward and recomputation."""

from harness import spans

ROOT = "lm.loss"      # opened once per step by loss_fn


def read(ctx):
    return spans.span_ms(ctx, "step", "moe.experts", ROOT)
