"""KDA: device ms per training step of the ``kda.mixer`` spans, every KDA
layer's mixer forward (projections, short convolutions, gates, the scan,
the gated norm, W_o), once in the forward pass and once more where the
backward recomputes the layer (its backward kernels run outside the
span)."""

from harness import spans

ROOT = "lm.loss"      # opened once per step by loss_fn


def read(ctx):
    return spans.span_ms(ctx, "step", "kda.mixer", ROOT)
