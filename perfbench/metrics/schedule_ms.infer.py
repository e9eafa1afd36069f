"""Dataflow: device ms per forward of the ``cgtrans.schedule`` span, the
destination-binned edge schedule that every forward builds."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "forward", "cgtrans.schedule", ROOT)
