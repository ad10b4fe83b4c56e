"""One run of one benchmark cell of the PyTorch/CUDA port of ERIS.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA cards.
``BENCHMARK.json`` names the cell; its configuration, traffic mix,
correctness limits and metric readers are files under ``perfbench/``
found by name:

    perfbench/configs/<config>.json        sizes as run, and the source
    perfbench/workloads/<traffic>.json     the round's settings and batch
    perfbench/limits/<cell>.json           the limit of each compared number
    perfbench/metrics/<metric>.py          read(ctx) -> number or None

``perfbench/drivers/fl_round.py`` runs the cell: every cell's traffic is
ERIS rounds.

With ``--trace 0`` the run reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  The last line on stdout is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared
number beside its limit); the checks are also the last lines on stderr.
A run exits non-zero and prints no result without the cards the cell
asks for, or when jax, jaxlib, flax or the JAX package ``repro`` was
loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# kernel and compiler caches at fixed paths inside the checkout (ignored
# by git), so that only a checkout's first run builds
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden import)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is a JAX
    one or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def guard() -> None:
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {found}")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> tuple:
    """(cell, configuration, traffic, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json "
                      f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "workloads" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics of its kind: per-layer with a trace, else
    end-to-end; a metric without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each metric's reader on the run's context; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for spec in specs:
        reader = load_module(BENCH_DIR / "metrics" / f"{spec['name']}.py",
                             f"perfbench_metric_{spec['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run_workload(workload: str, seed: int, seconds: float, trace: bool,
                 device, *, bench: dict | None = None,
                 config: dict | None = None, traffic: dict | None = None,
                 t_start: float | None = None) -> dict:
    """One run of ``workload`` on ``device``: the result's fields but
    ``device``.  ``config`` and ``traffic`` replace the cell's files
    (the tests' small sizes)."""
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    from perfbench.drivers import fl_round
    cell, cfg_file, traffic_file, limits = cell_files(bench, workload)
    config, traffic = config or cfg_file, traffic or traffic_file
    out = fl_round.run_cell(cell, config, traffic, limits, seed, seconds,
                            trace, device,
                            T_START if t_start is None else t_start, guard)
    guard()
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": read_metrics(metrics_for(bench, workload, trace),
                                      out["ctx"])}
    if trace and "breakdown" in out["ctx"]:
        result["breakdown"] = out["ctx"]["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in out["checks"]}
    result["ctx"] = out["ctx"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell, *_ = cell_files(bench, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device (torch.cuda.is_available() is "
                          "False)")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{args.workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
        result = run_workload(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda"),
                              bench=bench)
        ctx = result.pop("ctx")
        checks = result.pop("checks")
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": cell["chips"],
                            "memory_peak_bytes": ctx["peak_bytes"]}
        if args.trace:
            result["device"]["busy_s"] = ctx["busy_s"]
            result["device"]["window_s"] = ctx["window_s"]
        result["checks"] = checks
        guard()
    except Refused as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    except BaseException:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            free, total = torch.cuda.mem_get_info()
            print(f"perfbench: failed with {torch.cuda.memory_allocated()} B "
                  f"allocated, reserved peak "
                  f"{torch.cuda.max_memory_reserved()} B, {free} B free of "
                  f"{total}", file=sys.stderr)
        raise
    print(f"perfbench: waited {ctx['waited_s']:.2f} s for the card's "
          f"memory; set-up {ctx['setup_s']:.1f} s, {ctx['rounds']} "
          f"rounds in {ctx['wall_s']:.1f} s, reference "
          f"{ctx['reference_s']:.1f} s, {ctx['still_leaves']} leaves "
          f"left out of the change", file=sys.stderr)
    print("perfbench: memory GB " + ", ".join(
        f"{k} {v / 1e9:.4f}" for k, v in ctx["memory"].items()),
        file=sys.stderr)
    for name, row in checks.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
