"""GAS ops: device ms per forward of the ``gas.find`` span, every
layer's gather of its input rows along the edges."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "forward", "gas.find", ROOT)
