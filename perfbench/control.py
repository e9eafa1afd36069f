"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults 1,2,3] [--calls 4]

For each seed of ``--seeds`` it runs the cell as a benchmark run does (the
inputs from the seed, set-up, the warm calls, ``--calls`` timed calls, the
check against the plain reference) with no window, and prints one JSON
line of the numbers compared: the program's readings, whose largest over a
dozen seeds is the lower reading of each limit. ``--control`` does the
same with TF32 on for every matrix product of the program (the precision
below the float32 that the configurations state, and PyTorch's own switch
for it): the smallest of those is the upper reading. ``--faults`` plants
each fault the cell can have (``harness.faults``) in turn. Every run of
one call shares the process, so set-up and the kernels' build are paid
once. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def tf32():
    import torch
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def reading(root: Path, workload: str, seed: int, calls: int, device: str,
            plant=contextlib.nullcontext) -> dict:
    """The numbers compared for one seed, with the context ``plant()``
    open while the program runs (set-up, warm calls and timed calls) and
    closed for the check."""
    import torch

    from harness import spec

    c = spec.cell(root, workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    runner = spec.entry_module(c).Runner(c, seed, device)
    with plant():
        runner.setup()
        runner.warm()
        for i in range(calls):
            runner.call(i)
    numbers, failed = runner.check(c.limits)
    del runner
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "failed": failed, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))

    from harness import faults, spec

    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    entry = spec.entry_module(spec.cell(ROOT, args.workload))
    runs = [("program", s, contextlib.nullcontext) for s in seeds(args.seeds)]
    runs += [("control", s, tf32) for s in seeds(args.control)]
    runs += [(f"fault:{f}", s, lambda f=f: faults.plant(entry, f))
             for s in seeds(args.faults) for f in entry.FAULTS]
    for kind, seed, plant in runs:
        out = reading(ROOT, args.workload, seed, args.calls, args.device,
                      plant)
        print(json.dumps({"kind": kind, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
