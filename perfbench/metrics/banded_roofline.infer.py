"""Kernels: the forward's aggregation bytes at the card's memory bandwidth
as a share (%) of the device time of ``banded_cluster_kernel`` in the
traced window."""

from harness import readers


def read(ctx):
    return readers.roofline(ctx, "banded_cluster_kernel", "banded_bytes")
