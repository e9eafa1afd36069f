"""Model step: the model's operations over the traced window as a share
(%) of the card's float32 peak (``harness.counts``)."""

from harness import readers


def read(ctx):
    return readers.mfu(ctx)
