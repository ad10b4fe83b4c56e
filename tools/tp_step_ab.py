#!/usr/bin/env python3
"""Time two trees of this repository's model-axis step on one card, in
turns: chip_smoke.py phase 16's three steps of eris-gptneo-1.3b at full
width at (data 1, model 2) (DSC on the fused int8 wire, adam lr 1e-5,
8 x 64 tokens), two ranks on cuda:0 over gloo.

    python3 tools/tp_step_ab.py --parent DIR [--pairs 1] [--out FILE]

DIR is another tree of this repository (for example ``git archive
<commit> | tar -x -C DIR``); the tree under test is the checkout that
holds this script.  Each run is a process of its own with that tree's
``chip_smoke.py`` and ``src`` first on the path: it builds the tree's
kernels into the tree's ``build/kernels/`` and spawns the two ranks,
which run the tree's own ``_tp_step`` (its gates included: the loss
falls, the wire and flash kernels launch as the step implies).  The runs
alternate parent, this, this, parent for each pair.  Prints each run's
step times (CUDA events, each rank's) and losses, and the medians of
each tree's steps, as one JSON line beside the card's name and power
limit, which ``--out`` also writes.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
WHO = ("parent", "this")


def _rank(rank: int, port: int, seed: int, out: str) -> None:
    import chip_smoke as cs
    cs._tp_env(rank, 2, port)
    from repro_torch.launch import mesh as mesh_lib
    import torch.distributed as dist
    dev = mesh_lib.init_process_group("cuda", backend="gloo")
    try:
        res = cs._tp_step(dev, seed, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    pathlib.Path(out, f"rank{rank}.json").write_text(json.dumps(
        {"ms": res["ms"], "losses": res["losses"]}))


def _worker(tree: pathlib.Path, seed: int, out: str) -> None:
    """One run of one tree: build its kernels, spawn the two ranks."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    _build.build()
    mp.spawn(_rank, args=(mesh_lib.free_port(), seed, out), nprocs=2,
             join=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.worker.resolve(), args.seed, args.worker_out)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    runs = []
    for i in range(args.pairs):
        for who in (WHO if i % 2 == 0 else WHO[::-1]) + \
                (WHO[::-1] if i % 2 == 0 else WHO):
            (ROOT / "build").mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
                subprocess.run([sys.executable, __file__, "--worker",
                                str(trees[who]), "--worker-out", out,
                                "--seed", str(args.seed)], check=True)
                ranks = [json.loads(pathlib.Path(out, f"rank{r}.json")
                                    .read_text()) for r in range(2)]
            runs.append({"tree": who, "ms": [r["ms"] for r in ranks],
                         "losses": ranks[0]["losses"]})
            steps = [[round(x, 1) for x in r["ms"]] for r in ranks]
            print(f"{who}: steps {steps} ms, losses {ranks[0]['losses']}",
                  flush=True)
    medians = {who: statistics.median(
        x for run in runs if run["tree"] == who for r in run["ms"]
        for x in r) for who in WHO}
    result = {"card": card, "runs": runs, "median_step_ms": medians}
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
