"""The comparison that decides ``correct`` for a training cell: the
program's readings of its first ``CHECK_ROUNDS`` rounds against the
plain reference's of the same rounds from the same inputs.

Three numbers, each a largest relative gap, and one count:

* ``loss_gap``: over every client's loss of every checked round,
  |program - reference| / |reference|.
* ``update_gap``: over the leaves, the gap between the norms of round
  1's update (what the server was handed) in the program and in the
  reference, over the larger of the reference's norm of that leaf and
  its median leaf's norm (some leaves are all but still).
* ``change_gap``: the same for each leaf's change x_T - x_0 over the
  checked rounds, over the leaves that the reference moves: a leaf
  whose round-1 gradient is under a thousandth of the median leaf's
  moves by round-off alone and is left out.

* ``mask_miss``: of ``inputs.SAMPLE`` coordinates drawn from the seed,
  those where the program's round-1 update is not zero but no client's
  RandP mask in the reference keeps the coordinate.  The norms above do
  not see direction: a mask drawn from a wrong key keeps each leaf's
  norms.  The masks are exact on both sides, so the limit is 0.

A gap of 1 means one side did not move a leaf the other moved; a state
that a round returns unchanged reads 1 on both norms.
"""
from __future__ import annotations

import statistics

STILL = 1e-3      # a leaf's gradient norm under this share of the median
CHECK_ROUNDS = 3  # the rounds both sides run before the comparison


def _norm_gap(prog: list, ref: list, keep: list) -> float:
    floor = statistics.median(ref[i] for i in keep)
    return max(abs(prog[i] - ref[i]) / max(ref[i], floor, 1e-30)
               for i in keep)


def gaps(prog: dict, ref: dict) -> dict:
    if prog["leaves"] != ref["leaves"]:
        raise ValueError(f"leaves differ: program {prog['leaves']}, "
                         f"reference {ref['leaves']}")
    pl = [x for row in prog["losses"] for x in row]
    rl = [x for row in ref["losses"] for x in row]
    if len(pl) != len(rl):
        raise ValueError(f"{len(pl)} program losses, {len(rl)} reference")
    every = list(range(len(ref["leaves"])))
    g_med = statistics.median(ref["grad_norms"])
    moved = [i for i in every if ref["grad_norms"][i] >= STILL * g_med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
        "update_gap": _norm_gap(prog["update_norms"], ref["update_norms"],
                                every),
        "change_gap": _norm_gap(prog["change_norms"], ref["change_norms"],
                                moved),
        "mask_miss": int(((prog["u_sample"] != 0)
                          & ~ref["mask_sample"]).sum()),
        "still_leaves": len(every) - len(moved),
    }


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every reading at or under its
    limit, and a finite number (NaN fails)."""
    rows = [(name, readings[name], limits[name]) for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
