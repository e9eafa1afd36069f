"""Model step: the model's operations of a training step
(``harness.lm_counts``: the chip's share, held experts at their average
slots, causal attention pairs, no recomputation) over the traced window,
as a share (%) of the card's bf16 dense peak."""

from harness import lm_counts


def read(ctx):
    if ctx.trace is None or ctx.unit != "step" or "flops" not in ctx.counts:
        return None
    return (100.0 * ctx.counts["flops"] * ctx.units
            / (ctx.trace.window_s * lm_counts.PEAK_FLOPS_BF16))
