"""KDA: device ms per training step of the ``kda.chunk`` spans, the
chunked delta-rule scan alone (its layout, the pair decays, the
triangular solve, the carry from chunk to chunk and the outputs), forward
and recomputation."""

from harness import spans

ROOT = "lm.loss"      # opened once per step by loss_fn


def read(ctx):
    return spans.span_ms(ctx, "step", "kda.chunk", ROOT)
