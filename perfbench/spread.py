"""Sets of benchmark runs of one cell, and the spread of each metric.

    python3 perfbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 \
        [--sets 2] [--seconds <s>] [--trace 0] [--out <file>]

Runs ``perfbench/run.py`` once per seed, one process after another, the
same seeds in every set; prints each run's result line and, per metric
and set, the median and the spread: the distance between the first and
the third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median. A bound is set from the widest spread of a metric over the
cells. ``--out`` keeps every result line. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "perfbench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            line = proc.stdout.strip().splitlines()[-1] if \
                proc.stdout.strip() else ""
            if proc.returncode != 0 or not line.startswith("{"):
                print(f"set {k} seed {seed}: exit {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", flush=True)
                continue
            res = json.loads(line)
            runs.append(res)
            print(json.dumps({"set": k, "seed": seed, **res}), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"set": k, "seed": seed, **res})
                            + "\n")
        sets.append(runs)
    for name in sorted({m for s in sets for r in s for m in r["metrics"]}):
        row = []
        for k, runs in enumerate(sets):
            vals = [r["metrics"][name]["value"] for r in runs
                    if name in r["metrics"]]
            if len(vals) >= 2:
                row.append(f"set {k}: median {statistics.median(vals)!r} "
                           f"spread {spread(vals):.5f} of {len(vals)}")
        print(f"{name}: " + "; ".join(row), flush=True)
    bad = sum(not r["correct"] for s in sets for r in s)
    print(f"runs {sum(len(s) for s in sets)}, not correct {bad}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
