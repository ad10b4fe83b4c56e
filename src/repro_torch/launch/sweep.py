"""Dry-run sweep: every (arch x shape x mesh) in its own process
(``repro/launch/sweep.py``).

Each combo runs ``python -m repro_torch.launch.dryrun`` in a fresh process
(its own fake world).  Records land in ``{out}/*.json``; a summary line a
combo is appended to ``{out}/sweep.log``.  The default shapes are the
reference's: ``train_4k`` and the three serving shapes.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--archs a,b] \\
        [--shapes s] [--meshes 16x16,2x16x16] [--extra "--dsc"] \\
        [--timeout 900]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ALL_ARCHS = [
    "phi3.5-moe-42b-a6.6b", "musicgen-medium", "hymba-1.5b",
    "starcoder2-3b", "internvl2-26b", "olmoe-1b-7b", "starcoder2-15b",
    "qwen3-32b", "qwen2-0.5b", "xlstm-350m", "eris-gptneo-1.3b",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ALL_ARCHS))
    ap.add_argument("--shapes", default=",".join(ALL_SHAPES))
    ap.add_argument("--meshes", default="16x16,2x16x16")
    ap.add_argument("--extra", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log = out / "sweep.log"
    fails = []
    combos = [(a, s, m) for a in args.archs.split(",")
              for s in args.shapes.split(",")
              for m in args.meshes.split(",")]
    t_start = time.time()
    for i, (arch, shape, mesh) in enumerate(combos):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if mesh == "2x16x16":
            cmd.append("--multi-pod")
        if args.tag:
            cmd += ["--tag", args.tag]
        cmd += [c for c in args.extra.split() if c]
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            ok = r.returncode == 0
            line = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
            if not ok:
                line = "FAIL " + (r.stderr.strip().splitlines()
                                  or ["?"])[-1][:300]
        except subprocess.TimeoutExpired:
            ok, line = False, f"FAIL timeout {args.timeout}s"
        stamp = (f"[{i+1}/{len(combos)} {time.time()-t_start:7.0f}s "
                 f"{time.time()-t0:5.0f}s] {arch} {shape} {mesh}: {line}")
        print(stamp, flush=True)
        with log.open("a") as f:
            f.write(stamp + "\n")
        if not ok:
            fails.append((arch, shape, mesh))
    print(f"DONE {len(combos) - len(fails)}/{len(combos)} ok; fails: {fails}")
    with log.open("a") as f:
        f.write(f"DONE fails={fails}\n")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
