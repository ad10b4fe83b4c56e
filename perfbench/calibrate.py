"""Readings that a cell's correctness limits are set from: the program's
gaps to the reference on many seeds, the control's (the reference in
fp8 put in the program's place) and the gaps of the program with a fault
planted, in one process so that the set-up is paid once.

    python perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--faults a,b]

prints one JSON line per reading: {"seed", "side", "loss_gap",
"update_gap", "change_gap"}, side being ``program``, ``control`` or a
fault's name.  The benchmark's own runs never run it.

Faults, each planted under ``FLRun.step`` (what a training cell can
have on one card):

* ``unchanged``: the server hands back the state it was given.
* ``half_batch``: each client's loss is taken over the first half of its
  rows, the mean over the rest.
* ``client_left_out``: the last client's transmitted vector never
  reaches the aggregators, who average the others (the exchange left
  out).
* ``wrong_mask_key``: the clients compress with the round's next role
  key (the noise key, a split off by one) in place of the compression
  key, so every RandP mask is drawn from a wrong key.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def plant(run, fault: str):
    """``run`` with ``fault`` planted; returns it."""
    pipe = run.pipeline
    if fault == "unchanged":
        class Still:
            def apply(self, state, u):
                return state
        run.pipeline = dataclasses.replace(pipe, server=Still())
    elif fault == "half_batch":
        loss = run.loss_fn

        def half(params, batch):
            return loss(params, batch[:max(1, batch.shape[0] // 2)])
        run.loss_fn = half
    elif fault == "client_left_out":
        inner = pipe.aggregate

        class LeftOut:
            def apply(self, keys, state, vs, K, weights=None,
                      collect_views=False):
                def first(it):
                    # no enumerate: it would hold each vector while the
                    # next client's is made
                    k = 0
                    for v in it:
                        if k < K - 1:
                            yield v
                        del v
                        k += 1
                return inner.apply(keys, state, first(vs), K - 1, weights,
                                   collect_views)
        run.pipeline = dataclasses.replace(pipe, aggregate=LeftOut())
    elif fault == "wrong_mask_key":
        class WrongKey:
            def __init__(self, stage):
                self.stage = stage

            def apply(self, keys, state, v, k, K=None):
                return self.stage.apply(keys._replace(comp=keys.noise),
                                        state, v, k, K)
        run.pipeline = dataclasses.replace(pipe, compress=tuple(
            WrongKey(st) for st in pipe.compress))
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")
    return run


FAULTS = ("unchanged", "half_batch", "client_left_out", "wrong_mask_key")


def program_readings(driver, config, traffic, seed, device, fault="none"):
    import torch
    cfg = driver.model_config(config)
    run = plant(driver.build(cfg, traffic, seed, device), fault)
    prog = driver.checked_rounds(run, cfg, traffic, seed, device)
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def readings(workload: str, seeds, control_seeds, fault_seeds, device,
             *, faults=FAULTS, emit=print) -> list:
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from perfbench import compare
    from perfbench import run as bench
    from perfbench.drivers import fl_round as driver
    from perfbench.reference import eris_round
    _, config, traffic, _ = bench.cell_files(
        bench.load_json(ROOT / "BENCHMARK.json"), workload)
    out = []
    for seed in seeds:
        sides = {"program": program_readings(driver, config, traffic, seed,
                                             device)}
        if seed in fault_seeds:
            for fault in faults:
                sides[fault] = program_readings(driver, config, traffic,
                                                seed, device, fault)
        if seed in control_seeds:
            sides["control"] = eris_round.run(config["model"], traffic,
                                              seed, device, fp8=True)
        ref = eris_round.run(config["model"], traffic, seed, device)
        bench.guard()
        for side, prog in sides.items():
            row = {"seed": seed, "side": side, **compare.gaps(prog, ref)}
            out.append(row)
            emit(json.dumps(row))
    return out


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import CACHE_DIRS
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, set(args.control_seeds),
             set(args.fault_seeds), torch.device("cuda"),
             faults=args.faults.split(","), emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
