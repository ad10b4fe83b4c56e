#!/usr/bin/env python3
"""Time two versions of the port's attention kernels on one card, in turns.

    python3 tools/kernel_ab.py --parent DIR [--seed 0] [--out FILE]

DIR is a checkout of an earlier commit of this repository (for example
``git archive <commit> | tar -x -C DIR``).  Its ``paged_attention.cu`` and
``flash_attention.cu`` are built with nvcc for sm_90a into
``build/kernels_parent/`` and called through their own C interfaces
(the paged kernel with one block a (request, kv head); the SIMT flash
forward, bf16 included); this tree's kernels are called through their
wrappers.  Both run on the same inputs, in CUDA graphs of back-to-back
calls, in the order parent, this tree, this tree, parent:

* ``paged_attention`` at the decode shapes of chip_smoke.py's phase 3
  (batch 8 at phase 4's mid-generation contexts, bf16 pools, one layer's
  pools of n_layers so each call finds its pool cold in L2), for
  eris-gptneo-1.3b and qwen2-0.5b;
* the bf16 flash forward at the four shapes of phase 6's timing, causal.

It checks that the two versions agree (the paged outputs within 2e-2,
the forward within two bf16 steps of each other) and prints one JSON line
of microseconds per call, which ``--out`` also writes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.serve import pages_for  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_parent(parent: pathlib.Path) -> dict:
    """The parent's two sources as shared libraries, built side by side."""
    out_dir = ROOT / "build" / "kernels_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    procs = {}
    for name in ("paged_attention", "flash_attention"):
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    paged = libs["paged_attention"].paged_attention_launch
    paged.argtypes = [_P] * 6 + [_I] * 8 + [_F] + [_I] * 2 + [_P]
    paged.restype = _I
    fwd = libs["flash_attention"].flash_fwd_launch
    fwd.argtypes = [_P] * 6 + [_I] * 5 + [_F, _I, _I, _I, _P]
    fwd.restype = _I
    return {"paged": paged, "fwd": fwd}


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"the parent's {what} launch failed: error {err}")


def _turns(parent_fn, this_fn, n: int) -> dict:
    """us per call of each, in the order parent, this, this, parent."""
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        fn = parent_fn if who == "parent" else this_fn
        times[who].append(smoke._graph_ms(fn, n) * 1e3)
    return {k: sorted(v) for k, v in times.items()}


def paged_ab(old, dev, seed: int, arch: str, ctx: list, bs: int) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    B, H, KV, hd, Lyr = len(ctx), cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.n_layers
    P = max(pages_for(c, bs) for c in ctx)
    q, kp, vp, tbl, c = smoke._inputs(gen, dev, B, H, KV, hd, bs, P, ctx,
                                      torch.bfloat16, torch.bfloat16,
                                      n_pools=Lyr)
    N = kp.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream

    def parent(i):
        _ok(old(q.data_ptr(), kp[i % Lyr].data_ptr(), vp[i % Lyr].data_ptr(),
                tbl.data_ptr(), c.data_ptr(), out.data_ptr(), B, H, KV, hd, N,
                bs, P, -1, hd ** -0.5, 1, 1, stream().cuda_stream), "paged")
        return out

    def this(i):
        return pa.paged_attention(q, kp[i % Lyr], vp[i % Lyr], tbl, c)

    diff = float((parent(0).float() - this(0).float()).abs().max())
    smoke.check(diff <= 2e-2, f"{arch}: the two paged kernels differ by "
                f"{diff:.3e}")
    row = _turns(parent, this, 4 * Lyr)
    print(f"  paged_attention {arch} B={B} H={H} KV={KV} hd={hd}: parent "
          f"{row['parent']} us, this tree {row['this']} us (max abs "
          f"difference {diff:.2e})", flush=True)
    return dict(row, max_abs_diff=diff)


def forward_ab(old, dev, seed: int, label: str, shape: tuple) -> dict:
    B, H, KV, S, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    q, k, v, _ = smoke._flash_inputs(gen, dev, B, H, KV, S, d, torch.bfloat16)
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=dev)
    strides = fa._strides(q, k, v, o)

    def parent(i):
        _ok(old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), strides, B, H, KV, S, d, d ** -0.5, 1, -1, 1,
                torch.cuda.current_stream().cuda_stream), "flash forward")
        return o

    def this(i):
        return fa.flash_fwd(q, k, v)[0]

    mine = this(0).float()
    theirs = parent(0).float()
    err = (mine - theirs).abs()
    smoke.check(bool((err <= 2 * smoke.FLASH_BF16_STEP * theirs.abs()
                      + 2 * smoke.TOL_F32).all()),
                f"{label}: the two forwards differ by {float(err.max()):.3e}")
    n = 24 if S <= 256 else 4
    row = _turns(parent, this, n)
    print(f"  flash_fwd {label} B={B} H={H} KV={KV} S={S} d={d}: parent "
          f"(SIMT) {row['parent']} us, this tree {row['this']} us",
          flush=True)
    return dict(row, max_abs_diff=float(err.max()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    old = build_parent(args.parent)
    _build.build(["paged_attention", "flash_fwd_sm90"])

    cfg = get_config("eris-gptneo-1.3b")
    requests = serve_lib.random_requests(cfg.vocab, smoke.REQUESTS,
                                         smoke.PROMPT_MIN, smoke.PROMPT_MAX,
                                         args.seed)
    bs = serve_lib.settings_for(requests, smoke.GEN, smoke.REQUESTS,
                                cache_dtype="bfloat16").block_size
    mid = [len(p) + smoke.GEN // 2 for p, _ in requests]
    result = {"card": card, "contexts": mid, "paged_attention": {},
              "flash_fwd": {}}
    for arch in ("eris-gptneo-1.3b", "qwen2-0.5b"):
        result["paged_attention"][arch] = paged_ab(old["paged"], dev,
                                                   args.seed, arch, mid, bs)
    for label, shape in smoke.FLASH_TIMED:
        result["flash_fwd"][label] = forward_ab(old["fwd"], dev, args.seed,
                                                label, shape)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
