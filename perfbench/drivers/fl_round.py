"""Driver for cells whose traffic is ERIS rounds: the port's
``repro_torch.core.fl.FLRun.step``, one round of K streamed clients
(gradient, shifted compression, the aggregators' compensated mean, the
server), as ``examples/fl_train_lm.py`` and ``launch/fl_train.py``
drive it.

Set-up builds one ``FLRun`` on the benchmark's weights and drives it
through its ``compare.CHECK_ROUNDS`` first rounds, each on new tokens;
what those rounds leave (each client's loss, each leaf's norm of round
1's update and of the change over the rounds, round 1's update at the
seed's sample of coordinates) is read then, and the same object goes on
into the window.  The window runs rounds back to
back on new tokens until ``seconds`` have passed, synchronising after
each.  A traced run times each client's gradient, each compress stage
and each round with CUDA events through the window, then profiles
the traffic's ``profile_rounds`` more after one round under the
profiler that is not kept (the profiler's own start-up).  After the window the program is freed and the
plain reference (``reference/eris_round.py``) follows the checked rounds
from the same inputs; ``compare.py`` decides.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import math
import time

import torch

from perfbench import compare, inputs
from perfbench.reference import eris_round

NAME_CHARS = 160      # a kernel's name in the breakdown, cut to this
FREE_SHARE = 0.9      # of the card's memory free before set-up builds
FREE_WAIT_S = 60.0    # the longest wait for it


# ------------------------------------------------------------- program
def model_config(config: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**config["model"])


def fl_config(traffic: dict, seed: int):
    from repro_torch.core.compressors import RandP
    from repro_torch.core.fl import FLConfig
    comp = traffic["compressor"]
    if comp["kind"] != "RandP":
        raise ValueError(f"unknown compressor {comp['kind']!r}")
    return FLConfig(compressor=RandP(p=comp["p"]), seed=seed,
                    **traffic["round"])


def leaf_layout(cfg) -> list:
    """(name, shape, offset, size) of the program's leaves in the flat
    vector, in ravel order."""
    from repro_torch.models import transformer as tr
    out, off = [], 0
    for name, shape in inputs.leaf_names(tr.param_spec(cfg)):
        size = math.prod(shape)
        out.append((name, shape, off, size))
        off += size
    return out


def build(cfg, traffic: dict, seed: int, device):
    """The program under test: an ``FLRun`` on the seed's weights."""
    from repro_torch.core.fl import FLRun
    from repro_torch.models import transformer as tr
    params = inputs.draw_tree(tr.param_spec(cfg), tr.DTYPES[cfg.dtype],
                              seed, device)
    return FLRun(fl_config(traffic, seed), params,
                 lambda p, b: tr.loss_fn(p, cfg, {"tokens": b}),
                 device=device)


def tokens(cfg, traffic: dict, seed: int, rnd: int, device):
    return inputs.round_tokens(seed, rnd, traffic["round"]["K"],
                               traffic["batch"], traffic["seq"], cfg.vocab,
                               device)


def _leaf_x0(cfg, leaf, seed, device):
    from repro_torch.models import transformer as tr
    name, shape, _, size = leaf
    return inputs.draw_leaf(name, shape, tr.DTYPES[cfg.dtype], seed,
                            device).float().reshape(size)


def checked_rounds(run, cfg, traffic: dict, seed: int, device) -> dict:
    """The traffic's first rounds through ``run.step``, and the program's
    readings of them: the same quantities the reference reads."""
    leaves = leaf_layout(cfg)
    lr = traffic["round"]["lr"]
    sample = inputs.sample_coords(seed, run.n, device)
    bounds = inputs.leaf_bounds(sample, [leaf[2] for leaf in leaves]
                                + [run.n])
    u_sample = torch.empty(sample.numel(), dtype=torch.float32,
                           device=device)
    update = []
    for r in range(compare.CHECK_ROUNDS):
        run.step(tokens(cfg, traffic, seed, r, device))
        if r > 0:
            continue
        # what the server was handed: u = (x_0 - x_1) / lr
        for j, (_, _, off, size) in enumerate(leaves):
            u = (_leaf_x0(cfg, leaves[j], seed, device)
                 - run.x[off:off + size]) / lr
            update.append(float(torch.linalg.vector_norm(u)))
            a, b = bounds[j], bounds[j + 1]
            u_sample[a:b] = u[sample[a:b] - off]
            del u
    change = [float(torch.linalg.vector_norm(
        run.x[leaf[2]:leaf[2] + leaf[3]] - _leaf_x0(cfg, leaf, seed, device)))
        for leaf in leaves]
    losses = [[float(x) for x in run.client_losses[r]]
              for r in range(compare.CHECK_ROUNDS)]
    return {"losses": losses, "update_norms": update,
            "change_norms": change, "leaves": [leaf[0] for leaf in leaves],
            "u_sample": u_sample.cpu()}


def wait_for_card(device) -> float:
    """Wait, at most ``FREE_WAIT_S``, until ``FREE_SHARE`` of the card's
    memory is free: a process that ran on the card just before may still
    be handing its memory back.  Returns the seconds waited."""
    free, total = torch.cuda.mem_get_info(device)   # makes the context
    t0 = time.monotonic()
    while free < FREE_SHARE * total and time.monotonic() - t0 < FREE_WAIT_S:
        time.sleep(0.25)
        free, total = torch.cuda.mem_get_info(device)
    return time.monotonic() - t0


# ------------------------------------------------------------ timing
def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _TimedStage:
    """A compress stage with CUDA events around each client's apply."""

    def __init__(self, stage, events: list):
        self.stage, self.events = stage, events

    def apply(self, keys, state, v, k, K=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function("perfbench.compress"):
            start.record()
            out = self.stage.apply(keys, state, v, k, K)
            end.record()
        self.events.append((start, end))
        return out


def instrument(run) -> tuple:
    """CUDA events around each client gradient and each compress stage's
    apply of ``run``; returns the two event lists."""
    grad_events, comp_events = [], []
    run.pipeline = dataclasses.replace(run.pipeline, compress=tuple(
        _TimedStage(st, comp_events) for st in run.pipeline.compress))
    grad = run._grad

    def timed_grad(x, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function("perfbench.grad"):
            start.record()
            g = grad(x, batch)
            end.record()
        grad_events.append((start, end))
        return g

    run._grad = timed_grad
    return grad_events, comp_events


def _ms(events: list) -> float:
    return sum(a.elapsed_time(b) for a, b in events)


def window(run, cfg, traffic, seed, device, seconds, first_round, trace):
    """Rounds back to back until ``seconds`` have passed.  Returns
    (rounds, wall seconds, per-round event times or None)."""
    timed = None
    if trace:
        grad_ev, comp_ev = instrument(run)
        timed = {"round": [], "grad": [], "compress": []}
    r = first_round
    _sync(device)
    t0 = time.monotonic()
    while True:
        toks = tokens(cfg, traffic, seed, r, device)
        if trace:
            grad_ev.clear()
            comp_ev.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        run.step(toks)
        if trace:
            end.record()
        _sync(device)
        r += 1
        if trace:
            timed["round"].append(start.elapsed_time(end))
            timed["grad"].append(_ms(grad_ev))
            timed["compress"].append(_ms(comp_ev))
        if time.monotonic() - t0 >= seconds:
            break
    return r - first_round, time.monotonic() - t0, timed


def profile(run, cfg, traffic, seed, device, first_round) -> dict:
    """``profile_rounds`` more rounds under torch.profiler, after one
    round that the profiler runs through and does not keep (its start-up
    stalls the first kernels): every device operation and every host
    operation, as (name, start ns, end ns), and the profiled window,
    from the first operation's start to the last one's end."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile
    kept = traffic["profile_rounds"]
    _sync(device)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=kept,
                                    repeat=1)) as prof:
        for r in range(first_round, first_round + 1 + kept):
            run.step(tokens(cfg, traffic, seed, r, device))
            _sync(device)
            prof.step()
    device_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host_ops.append(row)
        elif not e.is_user_annotation():
            # kernels, copies and sets; a record_function's device-side
            # span is no operation
            device_ops.append(row)
    rows = host_ops + device_ops
    window = ((min(r[1] for r in rows), max(r[2] for r in rows))
              if rows else (0, 0))
    return {"device_ops": device_ops, "host_ops": host_ops,
            "window": window}


def busy_intervals(ops: list, window: tuple) -> list:
    """The union of the operations' intervals, clipped to the window."""
    lo_w, hi_w = window
    spans = sorted((max(a, lo_w), min(b, hi_w)) for _, a, b in ops
                   if b > lo_w and a < hi_w)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation running when each began."""
    by_name: dict = {}
    for name, a, b in prof["device_ops"]:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(prof["device_ops"], prof["window"])
    lo_w, hi_w = prof["window"]
    gaps, prev = [], lo_w
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi_w > prev:
        gaps.append((prev, hi_w))
    host = sorted(prof["host_ops"], key=lambda r: r[1])
    starts = [r[1] for r in host]
    named: dict = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        # the shortest host operation covering the gap's start, among
        # the few thousand that began last before it
        j = bisect.bisect_right(starts, a)
        inner = min((r for r in host[max(0, j - 4096):j] if a < r[2]),
                    key=lambda r: r[2] - r[1], default=("(no host op)",))
        named[inner[0]] = named.get(inner[0], 0) + (b - a)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n[:NAME_CHARS], ns / 1e9] for n, ns in idle]}


# ----------------------------------------------------------------- run
def run_cell(cell: dict, config: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, trace: bool, device,
             t_start: float, guard) -> dict:
    """One run of a cell.  Returns the context the metric readers read
    and the correctness verdict; ``guard()`` raises when a forbidden
    module is loaded."""
    cfg = model_config(config)
    on_card = torch.device(device).type == "cuda"
    waited = wait_for_card(device) if on_card else 0.0
    run = build(cfg, traffic, seed, device)
    stages = {}
    if on_card:
        # the drawn tree is freed once FLRun has ravelled it: its cached
        # blocks would otherwise be split under the round's own tensors
        stages["built_reserved"] = torch.cuda.memory_reserved(device)
        torch.cuda.empty_cache()
    prog = checked_rounds(run, cfg, traffic, seed, device)
    if on_card:
        # and the check's own per-leaf temporaries, before the window
        stages["checked_reserved"] = torch.cuda.memory_reserved(device)
        torch.cuda.empty_cache()
    _sync(device)
    setup_s = time.monotonic() - t_start
    first = compare.CHECK_ROUNDS
    rounds, wall, timed = window(run, cfg, traffic, seed, device, seconds,
                                 first, trace)
    guard()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    memory = ({"program_peak": peak,
               "program_reserved": torch.cuda.max_memory_reserved(device),
               **stages, "free_at_end": torch.cuda.mem_get_info(device)[0],
               "card": torch.cuda.get_device_properties(device).total_memory}
              if on_card else {})
    prof = (profile(run, cfg, traffic, seed, device, first + rounds)
            if trace else None)
    window_losses = torch.stack(
        [x for per_round in run.client_losses[first:first + rounds]
         for x in per_round])
    failed_rounds = int((~window_losses.view(rounds, -1).isfinite())
                        .any(1).sum())
    x_finite = bool(run.x.isfinite().all())
    n = run.n
    del run, window_losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        memory["left"] = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_ref = time.monotonic()
    ref = eris_round.run(config["model"], traffic, seed, device)
    reference_s = time.monotonic() - t_ref
    if on_card:
        memory["reference_peak"] = torch.cuda.max_memory_allocated(device)
        memory["reference_reserved"] = torch.cuda.max_memory_reserved(device)
    readings = compare.gaps(prog, ref)
    correct, rows = compare.verdict(readings, limits)
    rows += [("window_rounds_failed", failed_rounds, 0),
             ("x_not_finite", int(not x_finite), 0)]
    correct = correct and failed_rounds == 0 and x_finite
    ctx = {"config": config, "traffic": traffic, "cell": cell, "n": n,
           "setup_s": setup_s, "rounds": rounds, "wall_s": wall,
           "peak_bytes": peak, "timed": timed, "profile": prof,
           "reference_s": reference_s, "memory": memory,
           "waited_s": waited,
           "still_leaves": readings["still_leaves"]}
    if prof:
        busy = busy_intervals(prof["device_ops"], prof["window"])
        ctx["busy_s"] = sum(b - a for a, b in busy) / 1e9
        ctx["window_s"] = (prof["window"][1] - prof["window"][0]) / 1e9
        ctx["breakdown"] = breakdown(prof)
    return {"ctx": ctx, "correct": correct, "checks": rows,
            "attempted": rounds, "failed": failed_rounds}
