"""The comparison that decides ``correct``, at a size a CPU test run
holds: the port through the whole harness agrees with the plain
reference; the same run with the timed path broken underneath comes out
not correct, once for each fault a training cell can have; the control
(the reference in fp8 in the program's place) reads above the limits.
The import rule: nothing a run loads is jax, jaxlib, flax or the JAX
package ``repro`` (top-level names compared whole), and the reference
loads nothing of the port either."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from _bench import ROOT, cell_files, small

from perfbench import calibrate, compare
from perfbench import run as bench
from perfbench.drivers import fl_round
from perfbench.reference import eris_round

CPU = torch.device("cpu")
CELL_NAMES = ("gptneo-round-fused", "olmoe-round-fused", "gptneo-round-jnp")


def _run(cell, seed):
    config, traffic = small(cell)
    return bench.run_workload(cell, seed, 0.5, False, CPU, config=config,
                              traffic=traffic, t_start=time.monotonic())


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_port_agrees_with_the_reference(cell):
    """At float32 the port and the reference take the same masks, codes,
    routes and rounds: every gap is round-off, far under the limits."""
    res = _run(cell, 2**40 + 17)
    assert res["correct"], res["checks"]
    for name in cell_files(cell)[2]:
        assert res["checks"][name]["value"] < 1e-4, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"round_ms", "setup_s"}   # no card: no peak


@pytest.mark.parametrize("fault", calibrate.FAULTS)
@pytest.mark.parametrize("cell", CELL_NAMES)
def test_a_broken_round_is_not_correct(cell, fault, monkeypatch):
    build = fl_round.build
    monkeypatch.setattr(fl_round, "build", lambda *a: calibrate.plant(
        build(*a), fault))
    res = _run(cell, 5)
    assert not res["correct"], res["checks"]
    if fault == "wrong_mask_key":
        # the norms do not see a mask's direction: the sample does
        assert res["checks"]["mask_miss"]["value"] > 1000, res["checks"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_the_control_fails(cell):
    """The reference in fp8, put in the program's place, fails the
    cell's limits on three seeds."""
    config, traffic = small(cell)
    limits = cell_files(cell)[2]
    for seed in (1, 2, 3):
        ref = eris_round.run(config["model"], traffic, seed, CPU)
        ctl = eris_round.run(config["model"], traffic, seed, CPU, fp8=True)
        ok, rows = compare.verdict(compare.gaps(ctl, ref), limits)
        assert not ok, rows


def test_gaps_read_one_for_a_leaf_left_still():
    ref = {"leaves": ["a", "b", "c"], "losses": [[2.0, 3.0]],
           "update_norms": [1.0, 2.0, 4.0], "change_norms": [1.0, 2.0, 4.0],
           "grad_norms": [1.0, 2.0, 1e-9],
           "u_sample": torch.tensor([0.5, 0.0, 0.0, -1.0]),
           "mask_sample": torch.tensor([True, True, False, True])}
    prog = dict(ref, update_norms=[1.0, 0.0, 4.0],
                change_norms=[1.0, 2.0, 0.0], losses=[[2.0, 3.3]],
                u_sample=torch.tensor([0.5, 0.25, 0.125, 0.0]))
    g = compare.gaps(prog, ref)
    assert g["update_gap"] == 1.0
    assert g["change_gap"] == 0.0          # leaf c is still in the reference
    assert g["loss_gap"] == pytest.approx(0.1)
    # kept-but-zero and kept-and-moved are sound; moved-where-dropped not
    assert g["mask_miss"] == 1
    ok, _ = compare.verdict({"a": float("nan")}, {"a": 1.0})
    assert not ok


_PROBE = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + '/src', {tests!r}]
import torch
from _bench import small
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    code = _PROBE.format(root=str(ROOT), tests=str(ROOT / "perfbench" /
                                                   "tests"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(
        "from perfbench import run as bench\n"
        "c, t = small('gptneo-round-fused')\n"
        "bench.run_workload('gptneo-round-fused', 3, 0.1, False, "
        "torch.device('cpu'), config=c, traffic=t, t_start=time.monotonic())")
    assert "repro_torch" in mods            # the port ran, and it is not
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level_modules(
        "from perfbench.reference import eris_round\n"
        "c, t = small('olmoe-round-fused')\n"
        "eris_round.run(c['model'], t, 3, torch.device('cpu'))\n"
        "eris_round.run(c['model'], t, 3, torch.device('cpu'), fp8=True)")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, mods


@pytest.mark.cuda
def test_the_control_fails_at_full_size():
    """On the card, at the first cell's own size: the control's readings
    against the reference's fail the limits (one seed; the three the
    limits were set from are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the full-size round holds "
                    "~70 GB of device memory")
    config, traffic, limits = cell_files("gptneo-round-fused")
    dev = torch.device("cuda")
    ref = eris_round.run(config["model"], traffic, 7, dev)
    ctl = eris_round.run(config["model"], traffic, 7, dev, fp8=True)
    ok, rows = compare.verdict(compare.gaps(ctl, ref), limits)
    assert not ok, rows
