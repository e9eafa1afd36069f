"""GAS ops: device ms per training step of the ``gas.gather_backward``
span, layer 1's gather backward: the cotangent's scatter-add through the
dense kernel and its wrapper."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    return spans.span_ms(ctx, "step", "gas.gather_backward", ROOT)
