"""Dispatch: the value bytes the scatter wrapper moves around the kernel
per byte the aggregation needs: (``gas.pad.bytes`` + ``gas.liveness.bytes``)
per forward over the forward's aggregation bytes (``harness.counts``)."""

from harness import spans

ROOT = "gcn.forward"      # opened once per call by the entry, gcn_forward_full


def read(ctx):
    pad = spans.counter(ctx, "forward", "gas.pad.bytes", ROOT)
    live = spans.counter(ctx, "forward", "gas.liveness.bytes", ROOT)
    if pad is None or live is None or "banded_bytes" not in ctx.counts:
        return None
    return (pad + live) / ctx.counts["banded_bytes"]
