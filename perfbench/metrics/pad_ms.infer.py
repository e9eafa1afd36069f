"""Dispatch: device ms per forward of the ``gas.pad`` span, the scatter
wrapper's dead-edge routing and the padding of destinations, values and
weights to the kernel's tiles."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "forward", "gas.pad", ROOT)
