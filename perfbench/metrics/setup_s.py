"""End to end: seconds from the start of the process to the first timed
call: imports, the card's start, the inputs made from the seed, the
program's partition, the warm calls and, on a checkout's first run, the
kernels' build."""


def read(ctx):
    return ctx.setup_s
