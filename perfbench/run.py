"""One run of one benchmark cell of the PyTorch port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The run makes the cell's inputs from the
seed on the card, warms every shape the cell uses, calls the cell's entry
back to back for ``--seconds`` (one call in flight: each ends in
``torch.cuda.synchronize()``), and then holds what the timed calls
produced against the plain reference. Its last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read from ``torch.profiler`` over the window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, which are also the last lines of standard error.

It exits non-zero and prints no result where the checkout has no
``src/repro_torch``, where the card or cards the cell asks for are
missing, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# modules that no process of this benchmark may load (top-level names)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def foreign_modules(names) -> list:
    """The top-level module names among ``names`` that are JAX's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & set(FOREIGN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, setup_clock=process_age_s) -> dict:
    """Everything of a run after the look for the card: the result
    object. ``setup_clock`` gives the seconds of set-up so far."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import peaks, readers, spec
    from harness import trace as trace_mod

    c = spec.cell(root, workload)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    entry = spec.entry_module(c)
    runner = entry.Runner(c, seed, device)
    marks = [setup_clock()]
    runner.setup()
    sync()
    marks.append(setup_clock())
    runner.warm()
    sync()
    setup_s = setup_clock()
    print("setup_s by phase: start to entry {:.2f}, inputs and layout {:.2f}, "
          "warm calls {:.2f}".format(marks[0], marks[1] - marks[0],
                                     setup_s - marks[1]), file=sys.stderr)

    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.start()
    n = 0
    with record_function(trace_mod.WINDOW):
        t0 = time.perf_counter()
        while True:
            runner.call(n)
            sync()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    tr = None
    if prof is not None:
        prof.stop()
        tr = trace_mod.from_profiler(prof)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = readers.Context(entry.UNIT, n, window_s, setup_s, runner.counts(),
                          tr)

    numbers, failed = runner.check(c.limits)
    del runner
    # a number that is not finite fails its limit and prints as null
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": c.limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in checks.values())

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = spec.metric_reader(root, m["name"]).read(ctx)
        if value is None:
            # e.g. a kernel that the trace shows without device time
            print(f"{m['name']}: nothing to read in this run; left out",
                  file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = peaks.power_limit_w()
    out = {"correct": bool(correct), "attempted": n, "failed": int(failed),
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program to measure: {ROOT / 'src' / 'repro_torch'} is "
              "missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    print(f"setup_s by phase: interpreter and torch import "
          f"{process_age_s():.2f}", file=sys.stderr)

    from harness import spec

    chips = spec.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); {found} found",
              file=sys.stderr)
        return 3
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    bad = foreign_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch "
              "port alone", file=sys.stderr)
        return 4
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
