"""The operation and byte counts against hand counts."""

import pytest

from harness import counts

V18, E22 = 1 << 18, 1 << 22


def test_reddit_forward_flops_by_hand():
    # combination products 2·V·1204·256, 2·V·512·256, 2·V·256·41; the
    # weighted aggregations 2·E·602 and 2·E·256
    hand = (2 * V18 * 1204 * 256 + 2 * V18 * 512 * 256 + 2 * V18 * 256 * 41
            + 2 * E22 * 602 + 2 * E22 * 256)
    got = counts.forward_flops(V18, E22, [602, 256], 256, 41)
    assert got == hand
    assert got == pytest.approx(243.0e9, rel=2e-3)


def test_reddit_train_flops_by_hand():
    fwd = counts.forward_flops(V18, E22, [602, 256], 256, 41)
    weights = 2 * V18 * 1204 * 256 + 2 * V18 * 512 * 256 + 2 * V18 * 256 * 41
    inputs = 2 * V18 * 256 * 41 + 2 * V18 * 512 * 256 + 2 * E22 * 256
    assert counts.train_flops(V18, E22, [602, 256], 256, 41) == \
        fwd + weights + inputs


def test_ogbn_forward_flops_by_hand():
    V, E = 1 << 20, 28 << 20
    hand = (2 * E * 32 + 2 * V * 64 * 256 + 2 * E * 256 + 2 * V * 512 * 256
            + 2 * V * 256 * 172)
    assert counts.forward_flops(V, E, [32, 256], 256, 172) == hand
    assert hand == pytest.approx(418e9, rel=3e-3)


def test_aggregation_bytes_by_hand():
    # layer 0: the table read once and the output written once (V·602·4
    # each), src + dst + weight (12 B) per edge
    l0 = 2 * V18 * 602 * 4 + 12 * E22
    l1 = 2 * V18 * 256 * 4 + 12 * E22
    assert counts.aggregation_bytes(V18, E22, 602) == l0
    assert l0 == pytest.approx(1.31e9, rel=3e-3)
    assert l1 == pytest.approx(0.587e9, rel=3e-3)
    assert counts.forward_aggregation_bytes(V18, E22, [602, 256]) == l0 + l1
    assert counts.backward_aggregation_bytes(V18, E22, [602, 256]) == l1
    # ≈ 0.57 ms of bound per forward at 3.35 TB/s
    assert (l0 + l1) / 3.35e12 == pytest.approx(0.567e-3, rel=5e-3)


def test_counts_match_a_tiny_count_of_the_work():
    """The aggregation's operations are one multiply and one add per edge
    and feature; the combination's, one per weight and vertex."""
    V, E, F, H, C = 4, 6, 3, 2, 5
    agg = E * F * 2
    comb = V * (2 * F) * H * 2 + V * (2 * H) * H * 2 + V * H * C * 2
    assert counts.forward_flops(V, E, [F, H], H, C) == agg + E * H * 2 + comb
