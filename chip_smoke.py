#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``): builds its
CUDA kernel, holds it to its plain torch version, and serves
eris-gptneo-1.3b at full width on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and nothing is caught:

1. device -- needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as nvidia-smi gives them.
2. build -- compiles every kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, started together) and prints the seconds.
3. kernel vs plain version -- ``paged_attention`` against
   ``paged_attention_ref`` on the card at (H, KV, hd) = (16, 16, 128) and
   (14, 2, 64), f32 and bf16, with and without a window, a ctx-0 row and
   ragged contexts over several pages; every row of batch 8 must be
   bit-identical to the same row alone.  Then both are timed at the
   decode shape of phase 4, beside the kernel's bound.
4. serving -- ``ServeEngine`` on eris-gptneo-1.3b (24 layers, d_model
   2048, bf16 params made from ``--seed``, bf16 cache): 8 requests of
   32-256 prompt tokens and 32 new tokens, greedy and sampled.  Asserts
   every request ends by length, every logit is finite, and the kernel
   ran n_layers times per decode step; then replays one decode step of
   the same engine state through the kernel and through the plain
   version and compares the logits; then serves qwen2-0.5b's smoke
   variant in f32 on the card and on the host and compares the tokens.
   A torch.profiler breakdown of three decode steps says where the
   step's time goes.
5. prints the ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": ...}`` line.

Builds go to ``build/kernels/`` (listed in .gitignore).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine, pages_for  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
KERNELS = ("paged_attention",)   # every kernel of the serving path

# kernel vs plain version: f32 agrees to summation order; with bf16 pools
# the plain version rounds its softmax weights to bf16 before the PV
# product while the kernel keeps them in f32
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# one full-width decode step, kernel vs plain version, bf16 end to end:
# the attention outputs differ by the weights' bf16 rounding in every
# layer, so the logits are held to a relative norm (their argmax may flip
# where random weights leave near ties; the agreement is printed)
LOGITS_REL_TOL = 3e-2

PROMPT_MIN, PROMPT_MAX, GEN, REQUESTS = 32, 256, 32, 8


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ------------------------------------------------------------ phase 1 / 2
def device_phase() -> torch.device:
    phase("1 device")
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # a reference states and sets both: full f32 products on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def build_phase() -> None:
    phase("2 build")
    t0 = time.monotonic()
    seconds = _build.build(KERNELS)
    print(f"built {list(KERNELS)} in {time.monotonic() - t0:.2f} s "
          f"(per source: {json.dumps(seconds)})")
    for name in KERNELS:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _inputs(gen, dev, B, H, KV, hd, bs, P, ctx, qdt, kvdt, n_pools=1):
    """q, (n_pools, N, KV, bs, hd) pools, shuffled block tables, ctx."""
    N = B * P + 1
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(qdt)
    shape = (n_pools, N, KV, bs, hd)
    kp = torch.randn(shape, generator=gen, device=dev).to(kvdt)
    vp = torch.randn(shape, generator=gen, device=dev).to(kvdt)
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(B, P).to(torch.int32)
    return q, kp, vp, tbl, torch.tensor(ctx, dtype=torch.int32, device=dev)


def kernel_cases(dev, seed):
    """Kernel vs plain version at the listed shapes.  Returns the largest
    absolute error seen."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bs, P = 16, 18
    # an inactive row, single tokens, page edges, and contexts over many
    # pages up to the table's reach
    ctx = [0, 1, 15, 16, 17, 100, 203, P * bs]
    worst = 0.0
    for H, KV, hd in ((16, 16, 128), (14, 2, 64)):
        for window in (None, 40):
            for qdt, kvdt in ((torch.float32, torch.float32),
                              (torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.bfloat16)):
                q, kp, vp, tbl, c = _inputs(gen, dev, len(ctx), H, KV, hd,
                                            bs, P, ctx, qdt, kvdt)
                kp, vp = kp[0], vp[0]
                out = pa.paged_attention(q, kp, vp, tbl, c, window=window)
                ref = pa.paged_attention_ref(q, kp, vp, tbl, c,
                                             window=window)
                torch.cuda.synchronize()
                tol = TOL_F32 if kvdt == torch.float32 else TOL_BF16
                err = (out.float() - ref.float()).abs()
                bound = tol + tol * ref.float().abs()
                check(bool((err <= bound).all()),
                      f"kernel disagrees with the plain version at H={H} "
                      f"KV={KV} hd={hd} window={window} q={qdt} "
                      f"pool={kvdt}: max err {float(err.max())}")
                check(not bool(out[0].any()), "ctx-0 row is not exact zeros")
                for b in range(len(ctx)):
                    one = pa.paged_attention(q[b:b + 1], kp, vp,
                                             tbl[b:b + 1], c[b:b + 1],
                                             window=window)
                    check(torch.equal(one[0], out[b]),
                          f"row {b} alone differs from row {b} of batch 8")
                worst = max(worst, float(err.max()))
                print(f"  H={H:2d} KV={KV:2d} hd={hd:3d} window={window} "
                      f"q={str(qdt)[6:]} pool={str(kvdt)[6:]}: max abs err "
                      f"{float(err.max()):.3e} (tol {tol:g}), ctx-0 row "
                      f"zero, batch-8 rows == batch-1 rows")
    return worst


def _graph_ms(fn, n: int) -> float:
    """Device time of one call of ``fn(i)``, i = 0..n-1, captured back to
    back in a CUDA graph so the host's enqueue cost is not measured."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def decode_shape_timing(dev, seed, cfg, ctx, block_size):
    """The kernel and its plain version at phase 4's decode shape: batch 8
    at the given contexts, one layer's pools out of n_layers so that,
    as in the decode step, each call finds its pool cold in L2."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    B, H, KV, hd = len(ctx), cfg.n_heads, cfg.n_kv_heads, cfg.hd
    P = max(pages_for(c, block_size) for c in ctx)
    q, kp, vp, tbl, c = _inputs(gen, dev, B, H, KV, hd, block_size, P, ctx,
                                torch.bfloat16, torch.bfloat16,
                                n_pools=cfg.n_layers)
    Lyr = cfg.n_layers
    out = pa.paged_attention(q, kp[0], vp[0], tbl, c)
    ref = pa.paged_attention_ref(q, kp[0], vp[0], tbl, c)
    err = float((out.float() - ref.float()).abs().max())
    ms = _graph_ms(lambda i: pa.paged_attention(q, kp[i % Lyr], vp[i % Lyr],
                                                tbl, c), 4 * Lyr)
    plain_ms = _graph_ms(lambda i: pa.paged_attention_ref(
        q, kp[i % Lyr], vp[i % Lyr], tbl, c), Lyr)
    # least work: each valid key and value read once, q/tables/ctx read
    # and out written once; 4 * H * hd f32 operations per key
    keys = sum(ctx)
    nbytes = (keys * KV * hd * 2 * kp.element_size()
              + 2 * q.numel() * q.element_size() + tbl.numel() * 4 + B * 4)
    ops = keys * H * hd * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  decode shape B={B} H={H} KV={KV} hd={hd} bs={block_size} "
          f"ctx={ctx}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
          f"us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({nbytes} bytes, {ops} ops), kernel at "
          f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


# ---------------------------------------------------------------- phase 4
class LogitSpy:
    """Wraps ``transformer.forward``/``paged_decode_step`` while the
    engine runs: counts non-finite logits on the device (no extra host
    sync) and times each call with CUDA events."""

    def __init__(self):
        self.bad = None
        self.events = {"prefill": [], "decode": []}
        self._saved = (tr.forward, tr.paged_decode_step)

    def _wrap(self, fn, kind):
        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[kind].append((start, end))
            nonfinite = (~torch.isfinite(out[0])).sum()
            self.bad = nonfinite if self.bad is None else self.bad + nonfinite
            return out
        return run

    def __enter__(self):
        tr.forward = self._wrap(self._saved[0], "prefill")
        tr.paged_decode_step = self._wrap(self._saved[1], "decode")
        return self

    def __exit__(self, *exc):
        tr.forward, tr.paged_decode_step = self._saved

    def ms(self, kind):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[kind]]


def serving_phase(dev, seed, cfg, params, requests, settings):
    # warm-up outside the measured run: cuBLAS handles, the loaded library
    warm = serve_lib.settings_for(requests[:1], 2, 1, cache_dtype="bfloat16")
    serve_lib.serve(ServeEngine(cfg, params, warm, device=dev), requests[:1])
    torch.cuda.synchronize()

    engine = ServeEngine(cfg, params, settings, device=dev)
    with LogitSpy() as spy:
        pa.paged_attention.launches = 0           # the main path starts
        t0 = time.monotonic()
        outs = serve_lib.serve(engine, requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = pa.paged_attention.launches    # the main path ended
    st = engine.stats()
    check(len(outs) == REQUESTS, f"{len(outs)} of {REQUESTS} requests came back")
    check(all(o.finish_reason == "length" and len(o.tokens) == GEN
              for o in outs), "a request did not finish by length")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.tokens),
          "a token outside the vocabulary")
    check(int(spy.bad) == 0, f"{int(spy.bad)} non-finite logits")
    check(st["decode_steps"] > 0 and
          launches == cfg.n_layers * st["decode_steps"],
          f"paged kernel launched {launches} times over "
          f"{st['decode_steps']} decode steps of {cfg.n_layers} layers")
    decode_ms, prefill_ms = spy.ms("decode"), spy.ms("prefill")
    ttft = [o.ttft_s for o in outs]
    metrics = {
        "wall_s": wall, "tokens_out": st["tokens_out"],
        "tokens_per_s": st["tokens_per_s"],
        "decode_tokens_per_s": (REQUESTS * st["decode_steps"]
                                / (sum(decode_ms) / 1e3)),
        "mean_ttft_ms": 1e3 * sum(ttft) / len(ttft),
        "max_ttft_ms": 1e3 * max(ttft),
        "decode_steps": st["decode_steps"],
        "decode_step_ms_mean": sum(decode_ms) / len(decode_ms),
        "decode_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
        "prefills": len(prefill_ms),
        "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
        "peak_blocks": st["peak_blocks"],
        "block_capacity": st["block_capacity"],
        "kernel_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serving " + json.dumps(metrics))
    print(f"  {REQUESTS} requests, {st['tokens_out']} tokens: "
          f"{metrics['tokens_per_s']:.1f} tok/s over the run, mean TTFT "
          f"{metrics['mean_ttft_ms']:.1f} ms, peak blocks "
          f"{st['peak_blocks']}/{st['block_capacity']}, kernel launches "
          f"{launches} = {cfg.n_layers} layers x {st['decode_steps']} steps")
    return launches, metrics


def replay_phase(dev, cfg, params, requests, settings, step_ms):
    """One decode step of a live engine state, through the kernel and
    through the plain version, on copies of the same pools; then a
    profile of that step against the run's decode step time."""
    engine = ServeEngine(cfg, params, settings, device=dev)
    for i, (prompt, samp) in enumerate(requests):
        engine.submit(prompt, sampling=samp, seed=i)
    for _ in range(4):
        engine.step()
    engine._schedule()
    tables, ctxs, toks, _ = engine._decode_batch()

    def step(use_kernel):
        pools = {n: t.clone() for n, t in engine.pools.items()}
        logits, _ = tr.paged_decode_step(
            engine.params, cfg, pools, tables, ctxs, toks,
            window=engine.window, use_kernel=use_kernel)
        return logits[:, 0].float()

    got, want = step(True), step(False)
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite logits in the replayed step")
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(rel <= LOGITS_REL_TOL,
          f"decode step logits, kernel vs plain: relative error {rel:.3e}")
    print(f"  replayed decode step at ctx {ctxs.tolist()}: logits kernel vs "
          f"plain relative error {rel:.3e} (tol {LOGITS_REL_TOL:g}), max abs "
          f"{float((got - want).abs().max()):.3e}, argmax agreement "
          f"{agree:.3f}")
    profile_steps(engine, cfg, tables, ctxs, toks, step_ms)


def profile_steps(engine, cfg, tables, ctxs, toks, step_ms):
    """torch.profiler over three decode steps: device kernels by time, the
    device's busy share of the unprofiled step time ``step_ms``, and the
    host ops by self time (the profiler inflates host time)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    pools = {n: t.clone() for n, t in engine.pools.items()}
    for _ in range(2):
        tr.paged_decode_step(engine.params, cfg, pools, tables, ctxs, toks)
    torch.cuda.synchronize()
    steps = 3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tr.paged_decode_step(engine.params, cfg, pools, tables, ctxs,
                                 toks)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3 / steps
    launches = sum(n for _, n in kernels.values()) / steps
    print(f"  profile: per decode step {launches:.0f} device kernels, "
          f"{busy_ms:.3f} ms busy; of the unprofiled {step_ms:.3f} ms step "
          f"the device is idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    device {us / steps:9.1f} us/step {n // steps:5d}x  "
              f"{name[:80]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        print(f"    host {e.self_cpu_time_total / steps:11.1f} us/step "
              f"{e.count // steps:5d}x  {e.key[:80]}")


def small_input_phase(dev, seed):
    """qwen2-0.5b's smoke variant (GQA 4/2, qkv bias, tied embeddings) in
    f32: greedy tokens on the card, through the kernel, equal the host's
    plain-torch tokens, which the CPU tests hold to the JAX reference."""
    cfg = get_config("qwen2-0.5b").smoke()
    requests = [(p, SamplingParams()) for p, _ in serve_lib.random_requests(
        cfg.vocab, 3, 5, 40, seed)]
    settings = serve_lib.settings_for(requests, 8, 3, cache_dtype="float32")
    host = tr.init_params(cfg, seed=seed, device="cpu")
    card = {k: (v.to(dev) if not isinstance(v, dict) else
                {n: t.to(dev) for n, t in v.items()})
            for k, v in host.items()}
    a = serve_lib.serve(ServeEngine(cfg, card, settings, device=dev),
                        requests)
    b = serve_lib.serve(ServeEngine(cfg, host, settings, device="cpu"),
                        requests)
    check([o.tokens for o in a] == [o.tokens for o in b],
          "qwen2-0.5b smoke: card and host greedy tokens differ")
    print(f"  qwen2-0.5b smoke f32: {len(a)} greedy streams on the card == "
          f"on the host")


# ------------------------------------------------------------------- main
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = device_phase()
    build_phase()

    cfg = get_config("eris-gptneo-1.3b")
    requests = serve_lib.random_requests(cfg.vocab, REQUESTS, PROMPT_MIN,
                                         PROMPT_MAX, args.seed)
    settings = serve_lib.settings_for(requests, GEN, REQUESTS,
                                      cache_dtype="bfloat16")

    phase("3 kernel vs plain version")
    worst = kernel_cases(dev, args.seed)
    # mid-generation contexts of phase 4's requests
    timing = decode_shape_timing(dev, args.seed, cfg,
                                 [len(p) + GEN // 2 for p, _ in requests],
                                 settings.block_size)

    phase("4 serving eris-gptneo-1.3b at full width")
    t0 = time.monotonic()
    params = tr.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"  {sum(t.numel() for t in _leaves(params))} params ({cfg.dtype}) "
          f"made in {time.monotonic() - t0:.2f} s; settings {settings}")
    launches, metrics = serving_phase(dev, args.seed, cfg, params, requests,
                                      settings)
    replay_phase(dev, cfg, params, requests, settings,
                 metrics["decode_step_ms_median"])
    small_input_phase(dev, args.seed)

    phase("5 result")
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:52",
        "launches": launches,
        "max_abs_err": max(worst, timing["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main()
