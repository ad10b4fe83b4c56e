#!/usr/bin/env python3
"""A markdown table of dry-run records (``launch/dryrun.py``'s JSON files,
as ``launch/sweep.py`` writes them): one row an arch, one column a shape
and mesh, each cell the per-device peak, argument bytes and model-axis
collective bytes in GB (1e9 B), the peak marked where it passes one 80 GB
card.

    python3 tools/dryrun_table.py experiments/dryrun \\
        [--shapes prefill_32k,decode_32k,long_500k]
"""
from __future__ import annotations

import argparse
import json
import pathlib

CARD_BYTES = 80e9


def cell(rec: dict) -> str:
    mem = rec["memory"]
    model = sum(rec["collective_bytes_per_device"]["axes"]
                .get("model", {}).values())
    over = " **>80**" if mem["peak_bytes"] > CARD_BYTES else ""
    return (f"{mem['peak_bytes'] / 1e9:.2f}{over} / "
            f"{mem['argument_bytes'] / 1e9:.2f} / {model / 1e9:.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("records")
    ap.add_argument("--shapes", default="prefill_32k,decode_32k,long_500k")
    args = ap.parse_args(argv)
    recs = {}
    for path in sorted(pathlib.Path(args.records).glob("*.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    cols = [(s, m) for s in args.shapes.split(",")
            for m in ("16x16", "2x16x16")]
    print("| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("| --- |" + " --- |" * len(cols))
    for arch in sorted({a for a, _, _ in recs}):
        print(f"| {arch} | " + " | ".join(
            cell(recs[(arch, s, m)]) if (arch, s, m) in recs else "missing"
            for s, m in cols) + " |")


if __name__ == "__main__":
    main()
