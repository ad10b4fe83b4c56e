"""Multi-pod dry run: one rank's step of a 256- or 512-rank mesh, run on
the meta device under an account (``repro/launch/dryrun.py``): the train
step for the training shapes, the serving step for the serving ones.

The reference lowers and compiles each (arch x shape x mesh) for 512
forced host devices and reads memory, cost and collective bytes from the
compiled HLO.  Here one process poses as rank 0 of a fake world of that
many ranks (``launch.mesh.init_dryrun_group``), builds the production
mesh over it, and runs :func:`~repro_torch.launch.train.lower_train_step`'s
step (or :func:`~repro_torch.launch.serve.lower_step`'s prefill or decode
step, which ``launch/serve.py`` says of) eagerly on meta tensors inside a
``launch.accounting.Account``: every
layer runs, every collective reports its group, and the kernels declare
their work, so the per-device flops, traffic, collective payloads and
peak memory come out without an HLO and without a trip count.  The
record has the reference's keys and file name; XLA's own keys
(``compile_s``, ``xla_cost_flops``, ``xla_cost_bytes``) are null.  The
config's dtype is kept, for the caches and pools too (the reference swaps
bf16 for f16 to dodge an XLA CPU abort; the byte widths are equal).  A
serving record's ``"tp"`` is ``{"size": model}``, as the reference's, and
``paged_workspace_bytes`` is the paged kernel's workspace, which persists
on a card between steps and so is not in the step's peak.

``--device cuda`` is the measured counterpart: the same step for real on
the card at a mesh the card holds (one rank under ``python``, or the
ranks of ``torchrun``), random weights and tokens from seed 0, one
warm-up step, then one step under the same account with the card's
``max_memory_allocated`` rise and the step's ms from CUDA events.  A
serving shape runs its program at the shape's global batch on the one
rank, the caches or pools (and tokens) drawn from seed 0; ``--opt`` cuts
a shape too large for the card (e.g. ``n_layers=1,vocab=4096``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
        [--multi-pod] [--dsc] [--int8-wire] [--pp 4 --microbatches 8] \\
        [--opt flash_attention=false] [--device cuda] [--out DIR]
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k [--multi-pod] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist


def _overrides(opt: str) -> dict:
    """``--opt k=v,k=v``: ModelConfig field overrides, the reference's
    parse."""
    kw = {}
    for item in (opt.split(",") if opt else []):
        k, v = item.split("=")
        kw[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)
    return kw


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_one(arch: str, shape_name: str, multi_pod: bool,
            use_dsc: bool = False, fsa: bool = True,
            grad_dtype: str = "float16", int8_wire: bool = False,
            save_hlo: bool = False, out_dir: str = "experiments/dryrun",
            tag: str = "", opt: str = "", pp: int = 1,
            microbatches: int = 1, device: str = "meta") -> dict:
    """One (arch, shape, mesh) case: its record, also written to
    ``{out_dir}/{arch}__{shape}{_mp}{_ppN}{_tag}.json``.  ``device`` is
    "meta" (the dry run) or "cuda" (the measured step)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.accounting import Account
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import shard_plan as sp

    shape = SHAPES[shape_name]
    serving = shape.kind != "train"
    if save_hlo:
        raise ValueError("--save-hlo: the port runs eagerly and has no HLO "
                         "text to save")
    if device not in ("meta", "cuda"):
        raise ValueError(f"device must be meta or cuda, got {device!r}")
    cfg = dataclasses.replace(get_config(arch), **_overrides(opt))
    settings = train_lib.TrainSettings(use_dsc=use_dsc, fsa=fsa,
                                       grad_dtype=grad_dtype,
                                       int8_wire=int8_wire,
                                       microbatches=microbatches)
    measured = {}
    t0 = time.time()
    if device == "meta":
        if not dist.is_initialized():
            mesh_lib.init_dryrun_group(512 if multi_pod else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, pipe=pp)
        if serving:
            step, inputs = serve_lib.lower_step(cfg, mesh, shape_name)
        else:
            step, inputs = train_lib.lower_train_step(cfg, mesh, shape_name,
                                                      settings)
        with Account(mesh, "meta", inputs=inputs) as acc:
            outputs = step(*inputs)
    else:
        if serving:
            mesh, step, inputs = _card_serve_step(cfg, shape, multi_pod, pp)
        else:
            mesh, step, inputs = _card_step(cfg, shape, settings, multi_pod,
                                            pp)
        outputs = step(*inputs)                 # warm-up: builds, cuBLAS
        if not serving:
            inputs = (*outputs[:3], *inputs[3:])
        del outputs
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with Account(mesh, "cuda", inputs=inputs) as acc:
            ev[0].record()
            outputs = step(*inputs)
            ev[1].record()
        torch.cuda.synchronize()
        measured = {"device": torch.cuda.get_device_name(0),
                    "step_ms": ev[0].elapsed_time(ev[1]),
                    "max_memory_allocated_rise":
                        torch.cuda.max_memory_allocated() - base}
    t_run = time.time() - t0
    rec = acc.record()

    model_size = sh.axis_size(mesh, "model")
    pipe_size = sh.axis_size(mesh, "pipe")
    plan = sp.build_plan(cfg, model_size)
    n_tp_sharded = sum(s.dim >= 0 for s in tree_leaves(
        sh.tp_specs(cfg, model_size)))
    pipe_plan = sp.build_pipeline_plan(cfg, pipe_size, microbatches)
    arg_bytes = _nbytes(inputs)
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(d) for d in mesh.mesh.shape),
        "devices": int(mesh.mesh.numel()), "kind": shape.kind,
        "fsa": fsa, "use_dsc": use_dsc, "grad_dtype": grad_dtype,
        "int8_wire": int8_wire,
        "wire_dtype": rec["collective_bytes"]["wire_dtype"],
        "tp": {"size": int(model_size), "attn": plan.attn,
               "ffn": plan.ffn, "vocab": plan.vocab, "moe": plan.moe,
               "mixer": plan.mixer, "seq": plan.seq,
               "ctx": plan.ctx, "seq_ce": plan.seq_ce,
               "sharded_leaves": int(n_tp_sharded)} if not serving
        else {"size": int(model_size)},
        "pp": {"size": int(pipe_size),
               "microbatches": int(microbatches),
               "layers_per_stage": pipe_plan.layers_per_stage,
               "bubble_fraction": pipe_plan.bubble_fraction},
        "param_bytes_per_device": sh.param_bytes_per_device(cfg, mesh),
        "tag": tag,
        "lower_s": round(t_run, 2), "compile_s": None,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        # counted per device as the step ran (launch/accounting.py)
        "flops_per_device": rec["flops"],
        "bytes_accessed_per_device": rec["traffic_bytes"],
        "collective_bytes_per_device": rec["collective_bytes"],
        # XLA's cost analysis: no XLA program here
        "xla_cost_flops": None,
        "xla_cost_bytes": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _nbytes(outputs),
            "temp_bytes": rec["peak_bytes"] - rec["argument_bytes"],
            "peak_bytes": rec["peak_bytes"] - rec["argument_bytes"]
            + arg_bytes,
        },
        "staging_bytes_per_device": rec["staging_bytes"],
        "paged_workspace_bytes": _paged_workspace(cfg, shape, inputs),
        "kernels": rec["kernels"],
        "run_device": device,
        **measured,
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = ("_mp" if multi_pod else "") \
        + (f"_pp{pp}" if pp > 1 else "") + (f"_{tag}" if tag else "")
    fname = out / f"{arch.replace('.', '_')}__{shape_name}{suffix}.json"
    fname.write_text(json.dumps(record, indent=1))
    return record


def _paged_workspace(cfg, shape, inputs) -> int:
    """The paged kernel's workspace at a paged decode's shapes (0 for any
    other step): it stays on the card between steps, so the record keeps
    it apart from the step's peak."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as tr
    if shape.kind != "decode" or cfg.family not in tr.paged_families():
        return 0
    _, pools, tables, _, _ = inputs
    _, _, kv, bs, hd = pools["k"].shape
    rows, pages = tables.shape
    heads = kv * (cfg.n_heads // cfg.n_kv_heads)
    return pa.workspace_bytes(rows, heads, kv, hd, pages, bs)


def _card_serve_step(cfg, shape, multi_pod: bool, pp: int):
    """The measured counterpart of a serving shape: the launcher's ranks
    (one under ``python``) as the client axis, the program at the shape's
    global batch, random params (seed 0, ``init_params``), caches or pools
    and tokens (seed 0)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import shapes as shp
    from repro_torch.models import transformer as tr
    if multi_pod:
        raise ValueError("--multi-pod needs 512 ranks; --device cuda runs "
                         "at a mesh the card holds")
    device = mesh_lib.init_process_group("cuda")
    mesh = mesh_lib.make_host_mesh(pipe=pp, device=device)
    window = (shp.decode_window(cfg, shape) if shape.kind == "decode"
              else None)
    step, inputs = serve_lib.serve_program(
        cfg, mesh, shape.kind, shape.global_batch, shape.seq_len, window,
        device=device, params=tr.init_params(cfg, seed=0, device=device))
    serve_lib.fill_inputs(inputs, cfg, seed=0)
    return mesh, step, inputs


def _card_step(cfg, shape, settings, multi_pod: bool, pp: int):
    """The measured counterpart's mesh, step and real inputs on the card:
    the launcher's ranks (one under ``python``) as the client axis, pipe
    ``pp`` minor to it, the shape's global batch of random tokens."""
    from repro_torch import random
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adam
    if multi_pod:
        raise ValueError("--multi-pod needs 512 ranks; --device cuda runs "
                         "at a mesh the card holds")
    device = mesh_lib.init_process_group("cuda")
    mesh = mesh_lib.make_host_mesh(pipe=pp, device=device)
    opt = adam(3e-4)
    step = train_lib.make_train_step(cfg, mesh, opt, settings, device=device)
    params = train_lib.store_params(tr.init_params(cfg, seed=0,
                                                   device=device),
                                    cfg, mesh, settings)
    gen = torch.Generator(device=device).manual_seed(0)
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (shape.global_batch, shape.seq_len - n_pre),
        generator=gen, device=device, dtype=torch.int32)}
    if cfg.frontend == "vlm":
        batch["frontend_embeds"] = torch.randn(
            (shape.global_batch, cfg.n_frontend_tokens, cfg.d_frontend),
            generator=gen, device=device, dtype=torch.float16)
    inputs = (params, opt.init(params),
              train_lib.init_dsc_state(cfg, mesh, settings, device=device),
              batch, random.PRNGKey(0).to(torch.uint32))
    return mesh, step, inputs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dsc", action="store_true")
    ap.add_argument("--no-fsa", action="store_true",
                    help="FedAvg baseline layout (replicated optimizer)")
    ap.add_argument("--grad-dtype", default="float16")
    ap.add_argument("--int8-wire", action="store_true",
                    help="int8 blocks + f32 scales as the FSA wire format")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port has no HLO")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="ModelConfig overrides, e.g. "
                         "seq_parallel=true,vocab=50176")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipe axis size (carved out of the data dim)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="1F1B microbatch count (train shapes)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"),
                    help="meta: the dry run; cuda: the step measured on "
                         "the card")
    args = ap.parse_args(argv)
    try:
        rec = run_one(args.arch, args.shape, args.multi_pod, args.dsc,
                      fsa=not args.no_fsa, grad_dtype=args.grad_dtype,
                      int8_wire=args.int8_wire, save_hlo=args.save_hlo,
                      out_dir=args.out, tag=args.tag, opt=args.opt,
                      pp=args.pp, microbatches=args.microbatches,
                      device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    mem_gib = rec["memory"]["peak_bytes"] / 2**30
    cb = rec["collective_bytes_per_device"]
    print(f"OK {rec['arch']} {rec['shape']} mesh={rec['mesh']} "
          f"run={rec['lower_s']}s peak={mem_gib:.2f}GiB/dev "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"coll={ {k: f'{v:.2e}' for k, v in cb.items() if isinstance(v, float) and v} }"
          + (f" step_ms={rec['step_ms']:.1f} on {rec['device']}"
             if "step_ms" in rec else ""))


if __name__ == "__main__":
    main()
