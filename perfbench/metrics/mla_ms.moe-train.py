"""Attention: device ms per training step of the ``mla.attention`` spans,
every layer's latent attention forward, once in the forward pass and once
more where the backward recomputes a checkpointed block (its backward
kernels run outside the span)."""

from harness import spans

ROOT = "lm.loss"      # opened once per step by loss_fn


def read(ctx):
    return spans.span_ms(ctx, "step", "mla.attention", ROOT)
