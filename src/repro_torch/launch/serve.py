"""Serving entry point: ``ServeSettings`` + ``ServeEngine`` on the card
(``repro/launch/serve.py``; its counterpart of ``examples/serve_batched.py``).

``main()`` serves N random prompts with random params at a config's full
width (``--smoke`` for its reduced variant) and prints the engine's
stats as JSON:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch eris-gptneo-1.3b \
        [--requests 8] [--gen 32] [--concurrency 8] [--device cuda] \
        [--ckpt DIR]

``--ckpt`` serves a ``launch/train.py --save`` artifact
(``ServeEngine.from_checkpoint``) in place of random params.

Serving over a ("data", "model") mesh is reached through the API, as
in the reference: one process per position, ``launch/mesh.
init_process_group`` and ``make_host_mesh(data, model)``, then
``ServeEngine(cfg, params, settings, mesh=mesh)`` or
``ServeEngine.from_checkpoint(path, cfg, settings, mesh=mesh)``.

The dry run's serving programs (:func:`lower_step`, run by
``launch/dryrun.py`` under ``launch.accounting.Account``) are the ones the
port serves with.  The reference lowers its prefill and its dense decode
under GSPMD, where XLA partitions them; the port has no GSPMD, so each
serving shape accounts the program that one rank of a serving mesh runs:

* ``prefill_32k``: the mesh engine's TP prefill, ``forward(mode=
  "prefill", tp=...)`` under the decode-safe plan
  (``dist/sharding.serve_plan``), on the rank's share of the batch,
  returning the last position's logits (gathered over the model group
  under a vocab-parallel plan) and the caches, as ``_prefill_fn`` does;
* ``decode_32k`` and ``long_500k`` for the paged families: the mesh
  engine's decode, ``paged_decode_step(..., tp=...)``, on the rank's
  slots and kv heads, through full block tables at ``seq_len - 1``
  cached positions.  Under a window only the pages the window touches
  are pool blocks; the table's earlier entries point at the scratch
  block, which neither the kernel nor its plain version reads, so a rank
  holds window + one page of positions, as the reference's ring does;
* the same shapes for ssm and hybrid, which neither engine serves: the
  reference's own program, the dense ``decode_step`` on the rank's batch
  with the params whole on every model position, writing the caller's
  K/V rings in place (the reference donates them).
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.convert import tree_leaves, tree_unflatten
from repro_torch.dist import collectives as cl
from repro_torch.dist import sharding as sh
from repro_torch.launch import shapes as shp
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (BlockAllocator, BlockBudgetExceeded,  # noqa: F401
                               Request, RequestOutput, SamplingParams,
                               ServeEngine, ServeSettings, pages_for)
from repro_torch.serve.cache import SCRATCH_BLOCK


def _rank_params(cfg: ModelConfig, tp: int, device: torch.device) -> dict:
    """Zeros of one model position's TP pieces at ``tp`` (the whole leaves
    at 1), in the config's dtype."""
    dtype = sh.FLOAT_DTYPES[cfg.dtype]
    shapes = [sh.tp_local_shape(shape, spec, tp) for (_, shape), spec in
              zip(sh.spec_items(cfg), tree_leaves(sh.tp_specs(cfg, tp)))]
    return tree_unflatten(sh.shape_tree(cfg, lambda shape: None),
                          [torch.zeros(s, dtype=dtype, device=device)
                           for s in shapes])


def window_tables(rows: int, seq_len: int, block_size: int,
                  window: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Full block tables of ``rows`` requests at ``seq_len`` positions and
    the pool blocks they need: each row's pages that the window touches
    (all of them without one) on blocks of their own after the scratch
    block, its earlier pages on the scratch block.  Returns ((rows, P)
    int32 tables, blocks with the scratch block)."""
    P = pages_for(seq_len, block_size)
    first = max(seq_len - window, 0) // block_size if window else 0
    live = P - first
    tables = np.full((rows, P), SCRATCH_BLOCK, np.int32)
    tables[:, first:] = 1 + np.arange(rows * live,
                                      dtype=np.int32).reshape(rows, live)
    return tables, 1 + rows * live


def serve_program(cfg: ModelConfig, mesh, kind: str, batch: int,
                  seq_len: int, window: Optional[int] = None,
                  settings: Optional[ServeSettings] = None,
                  device: DeviceLike = None, params: Optional[dict] = None):
    """This rank's serving step of ``kind`` ("prefill" or "decode") for a
    global batch of ``batch`` sequences of ``seq_len`` positions, and its
    inputs on ``device``: ``(step, inputs)``, ``step(*inputs)`` one step
    (the module docstring says which program).  ``mesh`` is a serving mesh
    (its pipe axis, if any, replicates the program) or None for one rank.

    ``params`` are whole leaves (cut here to the rank's TP pieces) or None
    for zeros of the pieces' shapes; the caches, pools and tokens are
    zeros for the caller to fill.  Prefill's inputs are ``(params,
    batch)``, the paged decode's ``(params, pools, block_tables,
    context_lens, tokens)``, the dense decode's ``(params, cache, token)``
    at position ``seq_len - 1``.  Of ``settings``, ``block_size``,
    ``cache_dtype`` (default: the config's dtype) and ``decode_kernel``
    ("naive" takes the plain version) hold; ``window`` is the decode
    window."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"serve_program: kind must be prefill or decode, "
                         f"got {kind!r}")
    settings = settings or ServeSettings(cache_dtype=cfg.dtype)
    device = resolve_device(device)
    rows = len(sh.serve_slots(batch, mesh))
    paged = kind == "decode" and cfg.family in tr.paged_families()
    # the recurrent families' decode runs whole on every model position
    model = 1 if kind == "decode" and not paged else sh.model_size(mesh)
    plan = sh.serve_plan(cfg, model)
    rt = None
    if plan.active:
        rt = tr.TPRuntime(mesh.get_group("model"), model,
                          sh.axis_rank(mesh, "model"), plan)
    if params is None:
        params = _rank_params(cfg, model if rt else 1, device)
    elif rt is not None:
        params = sh.tp_piece(params, cfg, model, rt.index)
    cache_dtype = tr.DTYPES[settings.cache_dtype]

    if kind == "prefill":
        batch_in = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                    for k, v in shp.token_spec(cfg, rows, seq_len).items()}

        @torch.no_grad()
        def prefill_step(params, batch):
            logits, caches, _ = tr.forward(
                params, cfg, batch["tokens"], mode="prefill",
                frontend_embeds=batch.get("frontend_embeds"), tp=rt)
            last = logits[:, -1:]
            if rt is not None and plan.vocab:
                last = cl.all_gather(last, rt.group, 2)
            return last, caches
        return prefill_step, (params, batch_in)

    token = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    if not paged:
        pos = seq_len - 1
        cache = tr.init_cache(cfg, rows, seq_len, window=window,
                              dtype=cache_dtype, device=device)

        def dense_step(params, cache, token):
            return tr.decode_step(params, cfg, cache, token, pos,
                                  window=window, donate=True)
        return dense_step, (params, cache, token)

    tables, blocks = window_tables(rows, seq_len, settings.block_size,
                                   window)
    kv_heads = len(sh.paged_pool_heads(cfg, plan, model,
                                       rt.index if rt else 0))
    pools = tr.init_paged_pools(cfg, blocks, settings.block_size,
                                cache_dtype, device, kv_heads)
    ctx = torch.full((rows,), seq_len - 1, dtype=torch.int32)
    use_kernel = settings.decode_kernel != "naive"

    def paged_step(params, pools, block_tables, context_lens, tokens):
        return tr.paged_decode_step(params, cfg, pools, block_tables,
                                    context_lens, tokens, window=window,
                                    use_kernel=use_kernel, tp=rt)
    return paged_step, (params, pools, torch.from_numpy(tables).to(device),
                        ctx.to(device), token)


def fill_inputs(inputs: tuple, cfg: ModelConfig, seed: int = 0) -> None:
    """Random values, in place, in a :func:`serve_program`'s inputs but
    its params: token ids uniform over the vocab, every float tensor (the
    caches or pools, vlm's frontend embeds) a normal draw, from ``seed``
    on the inputs' device; the block tables and lengths stay as built."""
    *_, last = inputs
    tokens = last["tokens"] if isinstance(last, dict) else last
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    tokens.random_(0, cfg.vocab, generator=gen)
    for t in tree_leaves(list(inputs[1:])):
        if t.is_floating_point():
            t.normal_(generator=gen)


def lower_step(cfg: ModelConfig, mesh, shape_name: str,
               settings: Optional[ServeSettings] = None):
    """This rank's prefill or decode step for (cfg, mesh, shape) on the
    meta device, and its inputs: the port's counterpart of the reference's
    ``jit(...).lower()`` (``launch/serve.py:54-86``), run under
    ``launch.accounting.Account`` by the dry run.  Returns ``(step,
    inputs)`` as :func:`serve_program`, at the shape's global batch and
    length.  ``settings.window`` overrides the shape's decode window
    (``shapes.decode_window``), as the reference's does; ``settings``
    defaults to the engine's, the caches in the config's dtype."""
    shape = shp.SHAPES[shape_name]
    if shape.kind == "train":
        raise ValueError(f"lower_step: {shape_name} is a training shape "
                         f"(launch/train.lower_train_step)")
    settings = settings or ServeSettings(cache_dtype=cfg.dtype)
    window = None
    if shape.kind == "decode":
        window = (settings.window if settings.window is not None
                  else shp.decode_window(cfg, shape))
    return serve_program(cfg, mesh, shape.kind, shape.global_batch,
                         shape.seq_len, window, settings, "meta")


# every third request samples, the rest are greedy (examples/serve_batched.py)
SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95)


def random_requests(vocab: int, n: int, lo: int, hi: int, seed: int
                    ) -> List[Tuple[List[int], SamplingParams]]:
    """n prompts of lo..hi tokens (inclusive) drawn from ``seed``, with the
    sampling settings of request i: sampled when i % 3 == 0, else greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, vocab, size=length).tolist()
        out.append((prompt, SAMPLED if i % 3 == 0 else SamplingParams()))
    return out


def settings_for(requests: Sequence[Tuple[List[int], SamplingParams]],
                 gen: int, concurrency: int, **over) -> ServeSettings:
    """Settings whose pool holds every request at once: one block table
    per request of prompt + ``gen`` tokens, plus the scratch block."""
    block_size = over.pop("block_size", 16)
    max_len = max(len(p) for p, _ in requests) + gen
    blocks = sum(pages_for(len(p) + gen, block_size) for p, _ in requests)
    return ServeSettings(max_concurrency=concurrency, block_size=block_size,
                         num_blocks=blocks + 1, max_model_len=max_len,
                         max_new_tokens=gen, **over)


def serve(engine: ServeEngine,
          requests: Sequence[Tuple[List[int], SamplingParams]]
          ) -> List[RequestOutput]:
    """Submit every request (request i keyed on seed i) and drain."""
    for i, (prompt, samp) in enumerate(requests):
        engine.submit(prompt, sampling=samp, seed=i)
    return engine.run()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="eris-gptneo-1.3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced variant, in float32")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--prompt-min", type=int, default=32)
    ap.add_argument("--prompt-max", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--decode-kernel", default="auto",
                    choices=("auto", "cuda", "naive"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="serve a launch/train.py --save artifact")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    requests = random_requests(cfg.vocab, args.requests, args.prompt_min,
                               args.prompt_max, args.seed)
    settings = settings_for(requests, args.gen, args.concurrency,
                            decode_kernel=args.decode_kernel,
                            cache_dtype=("float32" if cfg.dtype == "float32"
                                         else "bfloat16"))
    if args.ckpt:
        engine = ServeEngine.from_checkpoint(args.ckpt, cfg, settings,
                                             device=args.device)
    else:
        engine = ServeEngine(cfg, tr.init_params(cfg, seed=args.seed,
                                                 device=args.device),
                             settings, device=args.device)
    outs = serve(engine, requests)
    stats = dict(engine.stats(), arch=cfg.name, device=str(engine.device),
                 requests=len(outs),
                 mean_ttft_s=float(np.mean([o.ttft_s for o in outs])),
                 finish_reasons=sorted({o.finish_reason for o in outs}))
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
