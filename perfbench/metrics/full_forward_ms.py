"""End to end: milliseconds per full-graph forward, the window on the host
clock (ending in ``torch.cuda.synchronize()``) over the forwards completed
in it."""

from harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, "forward")
