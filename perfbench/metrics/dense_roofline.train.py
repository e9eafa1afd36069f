"""Kernels: the backward's transposed-aggregation bytes at the card's
memory bandwidth as a share (%) of the device time of
``dense_cluster_kernel`` in the traced window."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "dense_cluster_kernel", "dense_bytes")
