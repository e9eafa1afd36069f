"""Dispatch: device ms per forward of the ``gas.liveness`` span, the
feature-block liveness pass over the padded values and its join onto the
banded walk's work list."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "forward", "gas.liveness", ROOT)
