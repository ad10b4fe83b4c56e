#!/usr/bin/env python3
"""Repeat chip_smoke.py phase 17's card-vs-host smoke step, to see which
side moves from one run to the next: the smoke variant of
eris-gptneo-1.3b in f32 at (data 2, pipe 2) on the int8 wire, 2
microbatches, two sgd steps, four ranks on cuda:0 over gloo.

    python3 tools/smoke_repeat.py [--seed 0]

Runs the steps once on the card, twice on the host at the process's
default intra-op threads, and three times on the host on one thread,
every run from the same params and keys.  Prints, beside the card's name
and power limit, one JSON line: each run's parameters after the two
steps against the second run's (the host at the default) and against
the fourth's (the host on one thread), as phase 17 gates them: the
relative error over every rank's pieces and the count of elements that
differ.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rank(rank: int, world: int, port: int, seed: int, out: str) -> None:
    import chip_smoke as cs
    cs._tp_env(rank, world, port)
    import torch
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    dev = mesh_lib.init_process_group("cuda", backend="gloo")
    mesh = cs._pipe_mesh(dev, 2, 2, 1)
    settings = train.TrainSettings(grad_dtype="float32", int8_wire=True,
                                   microbatches=2)
    default = torch.get_num_threads()
    cpu = torch.device("cpu")
    plan = [(dev, default), (cpu, default), (cpu, default), (cpu, 1),
            (cpu, 1), (cpu, 1)]
    runs = []
    for d, threads in plan:
        torch.set_num_threads(threads)
        x, _ = cs._smoke_run(d, seed, mesh, settings)
        runs.append((f"{d.type} threads {threads}", x))
    torch.set_num_threads(default)
    res = {"default_threads": default, "runs": []}
    for name, x in runs:
        row = {"run": name}
        for ref in (1, 3):
            y = runs[ref][1]
            sums = cl.all_reduce(torch.stack([
                (x - y).square().sum(), y.square().sum(),
                (x != y).sum().double()]).double(), dist.group.WORLD)
            row[f"vs_run_{ref}"] = {"rel": float(sums[0].sqrt()
                                                 / sums[1].sqrt()),
                                    "differ": int(sums[2])}
        res["runs"].append(row)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.multiprocessing as mp
    import chip_smoke as cs
    from repro_torch.launch import mesh as mesh_lib
    cs.device_phase()
    cs.build_phase()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with tempfile.TemporaryDirectory() as tmp:
        out = str(pathlib.Path(tmp, "res.json"))
        mp.spawn(_rank, args=(4, mesh_lib.free_port(), args.seed, out),
                 nprocs=4, join=True)
        res = json.loads(pathlib.Path(out).read_text())
    print(card.strip())
    print(json.dumps(res))


if __name__ == "__main__":
    main()
