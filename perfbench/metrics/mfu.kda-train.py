"""Model step: the hybrid model's operations of a training step
(``harness.kda_counts``: the chip's share, KDA's matrices and its delta
rule's three products a token and head, MLA's causal pairs, held experts
at their average slots, no recomputation) over the traced window, as a
share (%) of the card's bf16 dense peak."""

from harness import kda_counts


def read(ctx):
    if ctx.trace is None or ctx.unit != "step" or "flops" not in ctx.counts:
        return None
    return (100.0 * ctx.counts["flops"] * ctx.units
            / (ctx.trace.window_s * kda_counts.PEAK_FLOPS_BF16))
