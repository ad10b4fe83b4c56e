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

The reference's ``lower_step`` lowers the decode step ahead of time for
the dry run's HLO accounting (``launch/dryrun.py``, ``launch/shapes.py``):
it belongs to ROADMAP queue 1.12, with those files.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer as tr
from repro_torch.serve import (BlockAllocator, BlockBudgetExceeded,  # noqa: F401
                               Request, RequestOutput, SamplingParams,
                               ServeEngine, ServeSettings, pages_for)

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
