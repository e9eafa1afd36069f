"""Dataflow: device ms per training step of the ``cgtrans.schedule`` span,
the destination-binned edge schedule that every step builds."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "step", "cgtrans.schedule", ROOT)
