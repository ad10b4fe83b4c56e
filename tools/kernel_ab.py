#!/usr/bin/env python3
"""Time two trees of this repository's attention kernels on one card, in
turns.

    python3 tools/kernel_ab.py --parent DIR [--seed 0] [--out FILE]

DIR is another tree of this repository: a checkout of an earlier commit
(for example ``git archive <commit> | tar -x -C DIR``), or a copy with one
kernel changed; the tree under test is the checkout that holds this
script (run the script of another checkout to test that one).  Each tree
runs in a process of its own with its own ``src`` first on the path: it
builds its kernels into its own ``build/kernels/`` and calls them through
its own wrappers (``paged_attention``, ``flash_fwd``, ``flash_dq``,
``flash_dkv``), so any two commits compare, whatever their kernels' C
interfaces.  Both make the same inputs from the seed:

* ``paged_attention`` at chip_smoke.py's decode shapes (batch 8 at phase
  4's mid-generation contexts, bf16 pools, one layer's pools of n_layers
  so each call finds its pool cold in L2), for eris-gptneo-1.3b and
  qwen2-0.5b;
* the flash forward, dq and dk/dv at phase 6's timed shapes, causal, in
  bf16 (``FLASH_TIMED``) and f32 (``FLASH_TIMED_F32``).

First each tree holds its outputs against its own plain versions, the
flash kernels under every mask of phase 6 (``FLASH_MASKS``), and reports
its largest error as a share of phase 6's gate; the two trees' outputs on
the causal inputs are compared with each other.  The run stops if the
tree under test misses its gate; the other tree's shares are only
reported, so a copy with a kernel cut down can be timed too.  Then each
kernel is timed in a CUDA graph of back-to-back calls, in ten pairs whose
order alternates (parent, this; this, parent; ...).  Prints one JSON line
of microseconds per call, every pair's and the medians, the shares and
the differences, with the card's name and power limit, which ``--out``
also writes.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = 10                          # alternating pairs of timings a kernel
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
WHO = ("parent", "this")


# ------------------------------------------------------ one tree's process
def _graph_ms(fn, n: int) -> float:
    """Device time of one call of ``fn(i)``, i = 0..n-1, captured back to
    back in a CUDA graph so the host's enqueue cost is not measured (as
    chip_smoke.py times its kernels)."""
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


def _share(got, want, tol: float, rel: float) -> float:
    """The largest error as a share of the gate tol + rel |want|."""
    err = (got.float() - want.float()).abs()
    return float((err / (tol + rel * want.float().abs())).max())


class Tree:
    """One tree's kernels on the card: inputs made from the seed, checked
    against the tree's plain versions, then timed on request."""

    def __init__(self, tree: pathlib.Path):
        sys.path.insert(0, str(tree / "src"))
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import ref
        self.build, self.fa, self.pa, self.ref = _build.build, fa, pa, ref
        self.dev = torch.device("cuda", 0)
        self.calls = {}                 # (case, kernel): (fn, n)

    def setup(self, req: dict) -> dict:
        built = self.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        shares, dump = {}, pathlib.Path(req["dump"])
        for i, case in enumerate(req["cases"]):
            gen = torch.Generator(device=self.dev).manual_seed(req["seed"])
            make = self._paged if case["kind"] == "paged" else self._flash
            shares[case["id"]], outs = make(gen, case, req)
            torch.save([t.cpu() for t in outs], dump / f"{i}.pt")
        torch.cuda.synchronize()
        return {"built": built, "shares": shares}

    def _paged(self, gen, case: dict, req: dict):
        B, H, KV, hd = case["B"], case["H"], case["KV"], case["hd"]
        L, bs, P = case["n_pools"], case["bs"], case["P"]
        N = B * P + 1
        dt = torch.bfloat16
        q = torch.randn(B, H, hd, generator=gen, device=self.dev).to(dt)
        kp = torch.randn(L, N, KV, bs, hd, generator=gen,
                         device=self.dev).to(dt)
        vp = torch.randn(L, N, KV, bs, hd, generator=gen,
                         device=self.dev).to(dt)
        perm = torch.randperm(N - 1, generator=gen, device=self.dev) + 1
        tbl = perm.reshape(B, P).to(torch.int32)
        ctx = torch.tensor(case["ctx"], dtype=torch.int32, device=self.dev)
        pa = self.pa
        out = pa.paged_attention(q, kp[0], vp[0], tbl, ctx)
        want = pa.paged_attention_ref(q, kp[0], vp[0], tbl, ctx)
        tol = req["tol"]["paged"]
        self.calls[(case["id"], "paged_attention")] = (
            lambda i: pa.paged_attention(q, kp[i % L], vp[i % L], tbl, ctx),
            4 * L)
        return {"out": _share(out, want, tol, tol)}, [out]

    def _flash(self, gen, case: dict, req: dict):
        B, H, KV, S, d = case["shape"]
        dtype = getattr(torch, case["dtype"])

        def one(heads):                 # (B, H, S, d) views of (B, S, H, d)
            return torch.randn(B, S, heads, d, generator=gen,
                               device=self.dev).to(dtype).transpose(1, 2)
        q, k, v, do = one(H), one(KV), one(KV), one(H)
        fa, ref = self.fa, self.ref
        tol = req["tol"]["f32"]
        rel = tol if dtype == torch.float32 else req["tol"]["bf16_step"]
        shares, causal_outs = {}, None
        for causal, window in req["masks"]:
            mask = dict(causal=causal, window=window)
            o, lse = fa.flash_fwd(q, k, v, **mask)
            delta = ref.flash_delta(o, do)
            got = (o, lse, fa.flash_dq(q, k, v, do, lse, delta, **mask),
                   *fa.flash_dkv(q, k, v, do, lse, delta, **mask))
            want = (*ref.flash_fwd_ref(q, k, v, **mask),
                    ref.flash_dq_ref(q, k, v, do, lse, delta, **mask),
                    *ref.flash_dkv_ref(q, k, v, do, lse, delta, **mask))
            for what, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
                shares[what] = max(shares.get(what, 0.0), _share(
                    a, b, tol, tol if what == "lse" else rel))
            if (causal, window) == (True, None):
                causal_outs = got
        o, lse, _, _, _ = causal_outs
        delta = ref.flash_delta(o, do)
        n = 24 if S <= 256 else 4
        for name, fn in (
                ("flash_fwd", lambda i: fa.flash_fwd(q, k, v)),
                ("flash_dq", lambda i: fa.flash_dq(q, k, v, do, lse, delta)),
                ("flash_dkv",
                 lambda i: fa.flash_dkv(q, k, v, do, lse, delta))):
            self.calls[(case["id"], name)] = (fn, n)
        return shares, causal_outs

    def time(self, req: dict) -> dict:
        fn, n = self.calls[(req["case"], req["kernel"])]
        return {"us": _graph_ms(fn, n) * 1e3}


def serve(tree: pathlib.Path) -> None:
    """Answer one JSON request a line on stdin with one JSON line on
    stdout; everything else goes to stderr."""
    reply_to, sys.stdout = sys.stdout, sys.stderr
    t = Tree(tree)
    for line in sys.stdin:
        req = json.loads(line)
        if req["op"] == "quit":
            break
        reply = getattr(t, req["op"])(req)
        reply_to.write(json.dumps(reply) + "\n")
        reply_to.flush()


# ------------------------------------------------------------ the controller
class Proc:
    def __init__(self, who: str, tree: pathlib.Path):
        self.who = who
        self.p = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--serve", str(tree)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)

    def send(self, **req) -> None:
        self.p.stdin.write(json.dumps(req) + "\n")
        self.p.stdin.flush()

    def read(self) -> dict:
        line = self.p.stdout.readline()
        if not line:
            raise RuntimeError(f"the {self.who} tree's process ended "
                               f"(exit code {self.p.wait()})")
        return json.loads(line)

    def ask(self, **req) -> dict:
        self.send(**req)
        return self.read()

    def stop(self) -> None:
        if self.p.poll() is None:
            try:
                self.send(op="quit")
                self.p.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.p.kill()
                self.p.wait()


def cases(smoke, seed: int) -> list:
    """The paged decode shapes and the flash timing shapes, as JSON."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serve import pages_for
    cfg = get_config("eris-gptneo-1.3b")
    requests = serve_lib.random_requests(cfg.vocab, smoke.REQUESTS,
                                         smoke.PROMPT_MIN, smoke.PROMPT_MAX,
                                         seed)
    bs = serve_lib.settings_for(requests, smoke.GEN, smoke.REQUESTS,
                                cache_dtype="bfloat16").block_size
    mid = [len(p) + smoke.GEN // 2 for p, _ in requests]
    out = []
    for arch in ("eris-gptneo-1.3b", "qwen2-0.5b"):
        c = get_config(arch)
        out.append(dict(id=f"paged {arch}", kind="paged", B=len(mid),
                        H=c.n_heads, KV=c.n_kv_heads, hd=c.hd, bs=bs,
                        P=max(pages_for(n, bs) for n in mid), ctx=mid,
                        n_pools=c.n_layers))
    for timed, dtype in ((smoke.FLASH_TIMED, "bfloat16"),
                         (smoke.FLASH_TIMED_F32, "float32")):
        for label, shape in timed:
            out.append(dict(id=f"{label} {dtype}", kind="flash",
                            shape=list(shape), dtype=dtype))
    return out


def _differences(dumps: dict, case: dict, i: int) -> dict:
    names = ("out",) if case["kind"] == "paged" else \
        ("o", "lse", "dq", "dk", "dv")
    a, b = (torch.load(dumps[who] / f"{i}.pt") for who in WHO)
    return {name: float((x.float() - y.float()).abs().max())
            for name, x, y in zip(names, a, b)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--serve", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve:
        serve(args.serve.resolve())
        return
    if args.parent is None:
        ap.error("--parent DIR is required")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    todo = cases(smoke, args.seed)
    result = {"card": card, "pairs": PAIRS,
              "trees": {who: str(t) for who, t in trees.items()},
              "cases": {}}
    procs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dumps = {who: pathlib.Path(tmp) / who for who in WHO}
        try:
            for who in WHO:
                dumps[who].mkdir()
                procs[who] = Proc(who, trees[who])
                procs[who].send(
                    op="setup", seed=args.seed + 12, cases=todo,
                    dump=str(dumps[who]), masks=smoke.FLASH_MASKS,
                    tol={"f32": smoke.TOL_F32, "paged": smoke.TOL_BF16,
                         "bf16_step": smoke.FLASH_BF16_STEP})
            setup = {who: procs[who].read() for who in WHO}
            missed = []
            for i, case in enumerate(todo):
                row = {"shares": {who: setup[who]["shares"][case["id"]]
                                  for who in WHO},
                       "max_abs_diff": _differences(dumps, case, i)}
                result["cases"][case["id"]] = row
                print(f"  {case['id']}: largest error as a share of the "
                      f"gate, parent {row['shares']['parent']}, this "
                      f"{row['shares']['this']}; the trees differ by "
                      f"{row['max_abs_diff']}", flush=True)
                missed += [f"{case['id']} {k} {v:.3f}" for k, v in
                           row["shares"]["this"].items() if v > 1.0]
            smoke.check(not missed, f"the tree under test misses its gate: "
                        f"{missed}")
            for case in todo:
                row = result["cases"][case["id"]]
                names = ("paged_attention",) if case["kind"] == "paged" \
                    else FLASH
                for name in names:
                    times = {who: [] for who in WHO}
                    for i in range(PAIRS):
                        for who in (WHO if i % 2 == 0 else WHO[::-1]):
                            times[who].append(procs[who].ask(
                                op="time", case=case["id"],
                                kernel=name)["us"])
                    row[name] = dict(times, **{
                        f"{who}_median": statistics.median(times[who])
                        for who in WHO})
                    print(f"  {name} {case['id']}: parent median "
                          f"{row[name]['parent_median']:.2f} us, this "
                          f"median {row[name]['this_median']:.2f} us",
                          flush=True)
        finally:
            for p in procs.values():
                p.stop()
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
