"""Runs of one cell, one process each, and the spread of each metric:
what a bound is set from.

    python perfbench/sets.py --workload <name> --seeds 1,2,3 --seconds 40 \\
        [--trace 1] [--out runs.jsonl]

runs ``perfbench/run.py`` once a seed, in turn, appends each run's
result line (or its failure) to ``--out``, and prints for each metric
the median, the quartiles (``statistics.quantiles(values, n=4)``) and
their distance as a share of the median.  The benchmark's runs never
call it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spread(values: list) -> dict:
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "n": len(values)}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "q1": q1, "q3": q3, "n": len(values),
            "spread": (q3 - q1) / med if med else None}


def one_run(workload, seed, seconds, trace) -> dict:
    cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    row = {"workload": workload, "seed": seed, "trace": trace,
           "rc": proc.returncode, "wall_s": time.monotonic() - t0}
    lines = proc.stdout.strip().splitlines()
    try:
        row["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        row["stdout_tail"] = proc.stdout[-2000:]
    row["stderr_tail"] = proc.stderr[-3000:]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = one_run(args.workload, seed, args.seconds, args.trace)
        rows.append(row)
        res = row.get("result", {})
        print(json.dumps({"seed": seed, "rc": row["rc"],
                          "wall_s": round(row["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "checks": res.get("checks")}), flush=True)
        if "result" not in row:
            print(row["stderr_tail"], flush=True)
        if args.out:
            out = ROOT / args.out
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    values: dict = {}
    for row in rows:
        for name, m in row.get("result", {}).get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
    print(json.dumps({name: spread(v) for name, v in values.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
