"""Dispatch: device kernels launched per hybrid LM training step in the
traced window."""

from harness import readers


def read(ctx):
    return readers.launches(ctx)
