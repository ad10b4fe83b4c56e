"""The port's dispatch-level account (``launch/accounting.py``) on the CPU.

* Each kernel wrapper's declaration, made on the meta device, against its
  plain version run on the CPU under an account: the declared flops equal
  the flops the plain version's matmuls count (dense, masked tiles
  included), and the declared bytes its operands and results.  Flash
  forward, dq and dk/dv in bf16 and f32, with and without a window, with
  GQA; the four wire kernels.
* A smoke ``loss_fn`` gradient counted on real CPU tensors against the
  same gradient counted on meta tensors: flops equal with the flash
  kernels (the plain versions counted on the CPU, the declarations on
  meta), flops and traffic equal without them (but for one host scalar);
  hymba's, whose selective scan loops over ``accounting.trips``, with
  flops and traffic equal.
* The collective record of one step at (data 2, model 2): a real
  four-rank gloo launch's rank 0 against the same step on the meta device
  at a fake world of 4, in the same process after the gloo group is gone.
* The account's peak counts a storage once whatever its views, and falls
  when a tensor is freed; a collective on a one-rank group records
  nothing.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (dsc_quantize, dsc_update,  # noqa: E402
                                 flash_attention as fa, quantize)
from repro_torch.kernels.ref import flash_delta  # noqa: E402
from repro_torch.launch.accounting import Account  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402


def _meta(*ts):
    return [torch.empty_like(t, device="meta")
            if isinstance(t, torch.Tensor) else t for t in ts]


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _counted(fn, *args, **kw):
    """(flops, result) of ``fn`` on CPU tensors under an account."""
    with Account(device="cpu") as acc:
        out = fn(*args, **kw)
    return acc.flops, out


def _declared(fn, *args, **kw):
    """The one kernel declaration ``fn`` makes on meta tensors, and no
    flops besides it."""
    with Account(device="meta") as acc:
        fn(*_meta(*args), **kw)
    (decl,) = acc.kernels.values()
    assert decl["launches"] == 1 and acc.flops == decl["flops"]
    return decl


FLASH = [(torch.float32, 4, 4, None), (torch.float32, 4, 2, 24),
         (torch.bfloat16, 4, 4, None), (torch.bfloat16, 6, 2, 24),
         (torch.bfloat16, 4, 1, None)]


@pytest.mark.parametrize("dtype,H,KV,window", FLASH,
                         ids=[f"{str(d)[6:]}-h{h}kv{kv}-w{w}"
                              for d, h, kv, w in FLASH])
def test_flash_declarations_equal_plain_counts(dtype, H, KV, window):
    g = torch.Generator().manual_seed(0)
    B, S, d = 2, 64, 16
    q = torch.randn(B, H, S, d, generator=g).to(dtype)
    k = torch.randn(B, KV, S, d, generator=g).to(dtype)
    v = torch.randn(B, KV, S, d, generator=g).to(dtype)
    kw = dict(causal=True, window=window)
    flops, (o, lse) = _counted(fa.flash_fwd, q, k, v, **kw)
    decl = _declared(fa.flash_fwd, q, k, v, **kw)
    assert decl["flops"] == flops == fa.dense_flops(q, 2)
    assert decl["bytes"] == _nbytes((q, k, v, o, lse))
    do = torch.randn(B, H, S, d, generator=g).to(dtype)
    delta = flash_delta(o, do)
    bwd = (q, k, v, do, lse, delta)
    flops, dq = _counted(fa.flash_dq, *bwd, **kw)
    decl = _declared(fa.flash_dq, *bwd, **kw)
    assert decl["flops"] == flops == fa.dense_flops(q, 3)
    assert decl["bytes"] == _nbytes(bwd) + _nbytes((dq,))
    flops, (dk, dv) = _counted(fa.flash_dkv, *bwd, **kw)
    decl = _declared(fa.flash_dkv, *bwd, **kw)
    assert decl["flops"] == flops == fa.dense_flops(q, 4)
    # bf16 with G > 1 query heads a kv head: the kernel writes f32
    # partials per query head, which group_sum adds up as aten ops
    outs = (2 * _nbytes((q,)) * 4 // q.element_size()
            if dtype == torch.bfloat16 and KV != H else _nbytes((dk, dv)))
    assert decl["bytes"] == _nbytes(bwd) + outs


def test_wire_declarations_equal_plain_counts():
    """The wire kernels do no matmul: the plain versions count no flops
    and the declarations none; the declared bytes are the operands and
    results."""
    g = torch.Generator().manual_seed(1)
    n = 1000
    x = torch.randn(n, generator=g)
    s = torch.randn(n, generator=g)
    flops, (q, sc) = _counted(quantize.quantize, x, 7)
    decl = _declared(quantize.quantize, x, 7)
    assert flops == decl["flops"] == 0
    assert decl["bytes"] == _nbytes((x, q, sc))
    flops, y = _counted(quantize.dequantize, q, sc)
    decl = _declared(quantize.dequantize, q, sc)
    assert flops == decl["flops"] == 0
    assert decl["bytes"] == _nbytes((q, sc, y))
    flops, (v, s2) = _counted(dsc_update.dsc_update, x, s, 3, p=0.5,
                              gamma=0.5)
    decl = _declared(dsc_update.dsc_update, x, s, 3, p=0.5, gamma=0.5)
    assert flops == decl["flops"] == 0
    assert decl["bytes"] == _nbytes((x, s, v, s2))
    flops, (q, sc, s2) = _counted(dsc_quantize.dsc_quantize, x, s, 3, 4,
                                  p=0.5, gamma=0.5)
    decl = _declared(dsc_quantize.dsc_quantize, x, s, 3, 4, p=0.5,
                     gamma=0.5)
    assert flops == decl["flops"] == 0
    assert decl["bytes"] == _nbytes((x, s, q, sc, s2))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
def test_loss_grad_counts_cpu_equal_meta(flash):
    """One smoke gradient (qwen2-0.5b smoke, f32, 2 x 128 tokens) counted
    on the CPU and on meta: the same flops; without the kernels the same
    aten ops, so the same traffic too."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="float32", flash_attention=flash)
    params = tr.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 128), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))

    def grad(p, t):
        leaves = [x.detach().requires_grad_() for x in
                  torch.utils._pytree.tree_leaves(p)]
        tree = torch.utils._pytree.tree_unflatten(
            leaves, torch.utils._pytree.tree_structure(p))
        loss = tr.loss_fn(tree, cfg, {"tokens": t})
        return torch.autograd.grad(loss, leaves)

    # makes the host constants that are cached (the attention's rounded
    # scale, an f32 ``.item()`` of 4 bytes that a CPU run cannot tell from
    # its device), whichever test of this process made them first
    grad(params, toks)
    with Account(device="cpu") as cpu:
        grad(params, toks)
    meta_params = torch.utils._pytree.tree_map(
        lambda x: torch.empty_like(x, device="meta"), params)
    with Account(device="meta") as meta:
        grad(meta_params, torch.empty_like(toks, device="meta"))
    assert cpu.flops == meta.flops > 0
    if flash:
        # full remat: each layer's forward kernel runs again in the
        # backward
        assert {k: v["launches"] for k, v in meta.kernels.items()} == {
            "flash_fwd": 2 * cfg.n_layers, "flash_dq": cfg.n_layers,
            "flash_dkv": cfg.n_layers}
        assert not cpu.kernels
    else:
        assert cpu.traffic_bytes == meta.traffic_bytes
        assert not meta.kernels


def test_hybrid_grad_counts_cpu_equal_meta():
    """hymba-1.5b's smoke gradient (f32, plain attention, 2 x 128 tokens:
    8 chunks of the selective scan a layer) counted on the CPU and on
    meta: the same flops and traffic.  A
    recorded graph makes the backward and the checkpoints' recompute of
    every chunk, so a loop over :func:`accounting.trips` runs all its
    trips on meta with grad enabled."""
    import dataclasses
    cfg = dataclasses.replace(get_config("hymba-1.5b").smoke(),
                              dtype="float32", flash_attention=False)
    params = tr.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 128), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))

    def grad(p, t):
        leaves = [x.detach().requires_grad_() for x in
                  torch.utils._pytree.tree_leaves(p)]
        tree = torch.utils._pytree.tree_unflatten(
            leaves, torch.utils._pytree.tree_structure(p))
        loss = tr.loss_fn(tree, cfg, {"tokens": t})
        return torch.autograd.grad(loss, leaves)

    grad(params, toks)          # makes the host constants that are cached
    with Account(device="cpu") as cpu:
        grad(params, toks)
    meta_params = torch.utils._pytree.tree_map(
        lambda x: torch.empty_like(x, device="meta"), params)
    with Account(device="meta") as meta:
        grad(meta_params, torch.empty_like(toks, device="meta"))
    assert 128 // cfg.scan_chunk > 2
    assert cpu.flops == meta.flops > 0
    assert cpu.traffic_bytes == meta.traffic_bytes
    assert not meta.kernels and not cpu.kernels


def test_peak_counts_storages_once():
    with Account(device="meta") as acc:
        x = torch.empty(1024, device="meta")          # 4 KiB
        views = [x[:10], x.view(32, 32), x.t() if x.dim() == 2 else x]
        y = x + 1                                     # 4 KiB more
        del x, views
        z = y * 2                                     # x freed: still 8
        del y, z
    assert acc.peak_bytes == 8192 and acc.live_bytes == 0
    assert acc.traffic_bytes == 4 * 4096              # y: 1 in 1 out; z


STEP_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, train as tl
    from repro_torch.launch.accounting import Account
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adam
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              dtype="float32")
    settings = tl.TrainSettings(int8_wire=True, grad_dtype="float32")
    opt = adam(1e-3)
    mesh_lib.init_process_group("cpu")
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    step = tl.make_train_step(cfg, mesh, opt, settings, device="cpu")
    params = tl.store_params(tr.init_params(cfg, seed=0, device="cpu"),
                             cfg, mesh, settings)
    state = (params, opt.init(params),
             tl.init_dsc_state(cfg, mesh, settings, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (8, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    with Account(mesh, "cpu", inputs=state) as acc:
        step(*state, {"tokens": toks}, random.PRNGKey(0))
    real, rank = acc.record(), dist.get_rank()
    dist.destroy_process_group()
    if rank != 0:
        sys.exit(0)
    mesh_lib.init_dryrun_group(4)
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device="cpu")
    step, (p, o, d, _, key) = tl.lower_train_step(cfg, mesh, "train_1k",
                                                  settings, opt)
    with Account(mesh, "meta") as acc:
        step(p, o, d, {"tokens": torch.empty((8, 64), dtype=torch.int32,
                                             device="meta")}, key)
    print("ACCOUNTS" + json.dumps({"real": real, "meta": acc.record()}))
    dist.destroy_process_group()
""")


def test_fake_world_collectives_equal_a_gloo_launch(tmp_path):
    """Rank 0 of a real (data 2, model 2) gloo step and the same step on
    the meta device in a fake world of 4: the same collective record,
    kind by kind, axis by axis, dtype by dtype, bytes and counts; the same
    flops (the flash plain versions counted on the CPU, the declarations
    on meta); no staging on the CPU."""
    script = tmp_path / "worker.py"
    script.write_text(STEP_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script)],
        cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("ACCOUNTS")][-1]
    out = json.loads(line[len("ACCOUNTS"):])
    real, meta = out["real"], out["meta"]
    assert real["collective_bytes"] == meta["collective_bytes"]
    cb = real["collective_bytes"]
    assert cb["wire_dtype"] == "s8"
    assert set(cb["axes"]) == {"client", "model"}
    assert real["flops"] == meta["flops"] > 0
    assert real["staging_bytes"] == meta["staging_bytes"] == 0
    assert np.isfinite(real["traffic_bytes"]) and real["peak_bytes"] > 0
