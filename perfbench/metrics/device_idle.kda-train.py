"""Device: the share (%) of the traced window in which no kernel, copy or
set ran on the card, over the hybrid LM training steps."""

from harness import readers


def read(ctx):
    return readers.idle(ctx)
