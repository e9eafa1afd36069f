"""Dispatch: device kernels launched per forward in the traced window."""

from harness import readers


def read(ctx):
    return readers.launches(ctx)
