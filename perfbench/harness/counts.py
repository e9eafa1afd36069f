"""Operations and bytes of the cells' work, from the shapes alone.

These count what the algorithm needs, whatever the program does: a fused
kernel and an unfused one get the same count, so a share of a roofline
made from them cannot pass 100 % by fusing.

Full-graph GraphSAGE (``gcn_forward_full``): layer i aggregates its input
h_i (V, f_i) over E weighted edges (``agg_i = A h_i``) and combines
``relu([h_i ‖ agg_i] W_i + b_i)`` with W_i (2 f_i, H); the output layer is
``h_L W_out`` with W_out (H, C). A multiply-add counts as 2 operations.
"""

from __future__ import annotations

EDGE_BYTES = 12      # src int32 + dst int32 + weight float32


def forward_flops(V: int, E: int, widths, H: int, C: int) -> int:
    """Model operations of one forward: each layer's weighted aggregation
    (2·E·f) and combination product (2·V·2f·H), and the output product."""
    return (sum(2 * E * f + 2 * V * 2 * f * H for f in widths)
            + 2 * V * H * C)


def train_flops(V: int, E: int, widths, H: int, C: int) -> int:
    """Model operations of one training step: the forward; every weight's
    gradient (as many as its forward product); and the input gradients
    that some parameter needs — the output layer's, and for each layer
    after the first the combination's input gradient and the transposed
    aggregation (2·E·f). Layer 0's input is the feature table, which
    needs no gradient."""
    fwd = forward_flops(V, E, widths, H, C)
    wgrad = sum(2 * V * 2 * f * H for f in widths) + 2 * V * H * C
    dgrad = 2 * V * H * C + sum(2 * V * 2 * f * H + 2 * E * f
                                for f in widths[1:])
    return fwd + wgrad + dgrad


def aggregation_bytes(V: int, E: int, f: int, itemsize: int = 4) -> int:
    """Bytes one aggregation over ``E`` edges must move: the input table's
    rows read once, each edge's source, destination and weight once, and
    the output rows written once."""
    return 2 * V * f * itemsize + EDGE_BYTES * E


def forward_aggregation_bytes(V: int, E: int, widths) -> int:
    """The aggregation bytes of one forward, all layers."""
    return sum(aggregation_bytes(V, E, f) for f in widths)


def backward_aggregation_bytes(V: int, E: int, widths) -> int:
    """The aggregation bytes of one backward: for each layer after the
    first, the transposed aggregation reads the cotangent rows once and
    the edges once, and writes the input's cotangent rows once."""
    return sum(aggregation_bytes(V, E, f) for f in widths[1:])
