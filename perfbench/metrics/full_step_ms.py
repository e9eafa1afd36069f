"""End to end: milliseconds per full-batch training step, the window on the
host clock (ending in ``torch.cuda.synchronize()``) over the steps
completed in it."""

from harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, "step")
