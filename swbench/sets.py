"""Sets of runs of one cell in one call, and their spreads, as the bounds
are set from them.

    python -m swbench.sets --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
        --seconds 30 [--trace 0] [--out chiprun_out/sets.jsonl]

Runs ``python3 -m swbench.run`` once per seed and set, one process at a
time, every set over the same seeds. Writes each run's result line (with
its seed, set, exit code and seconds) to ``--out`` and prints, per metric,
each set's median and spread (the quartiles' distance over the median), the
mean of the sets' spreads with each set's run farthest from its median
left out, and the spread of all runs together.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .stats import spread


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "swbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return {"seed": seed, "rc": proc.returncode, "seconds": time.time() - t0,
            "line": line, "stderr_tail": proc.stderr[-3000:]}


def trimmed(values: list[float]) -> list[float]:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    drop = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:drop] + values[drop + 1 :]


def summary(runs: list[dict]) -> dict:
    sets: dict[int, list[dict]] = {}
    for r in runs:
        if r["line"]:
            sets.setdefault(r["set"], []).append(r["line"]["metrics"])
    names = sorted({m for ms in sets.values() for m in ms[0]}) if sets else []
    out = {}
    for name in names:
        per = [[m[name]["value"] for m in ms if name in m] for _, ms in sorted(sets.items())]
        everything = [v for vs in per for v in vs]
        row = {"medians": [statistics.median(vs) for vs in per],
               "spreads": [spread(vs) for vs in per if len(vs) >= 2]}
        if all(len(vs) >= 3 for vs in per):
            row["trimmed_spread_mean"] = statistics.mean(spread(trimmed(vs)) for vs in per)
        if len(everything) >= 2:
            row["spread_all"] = spread(everything)
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swbench.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            r = dict(one_run(args.workload, seed, args.seconds, args.trace), set=k)
            runs.append(r)
            brief = {key: r[key] for key in ("set", "seed", "rc", "seconds")}
            if r["line"]:
                brief.update(correct=r["line"]["correct"], metrics={
                    n: m["value"] for n, m in r["line"]["metrics"].items()})
            else:
                brief["stderr_tail"] = r["stderr_tail"][-1500:]
            print(json.dumps(brief), flush=True)
            if args.out:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(r) + "\n")
    print(json.dumps({"workload": args.workload, "summary": summary(runs)}), flush=True)
    return 0 if all(r["rc"] == 0 and r["line"] and r["line"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
