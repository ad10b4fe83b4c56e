"""Federated training of a transformer LM with ERIS on the card: the
port's counterpart of ``examples/fl_train_lm.py``.

K clients hold disjoint token streams; every round each takes a gradient
on its own data, DSC shift-compresses it (on the int8 wire with
``--int8-wire``), the aggregators reduce their FSA shards, and the server
applies the update.  Without ``--full`` the config is the architecture's
reduced smoke variant, as the example runs it; with ``--full`` it is the
published width (eris-gptneo-1.3b: 1.8e9 parameters, one 80 GB card).
Params are random from ``--seed``; the clients' tokens are the example's,
``lm_token_batches(fold_in(PRNGKey(seed), 1), ...)`` from the threefry
stream.  ``--impl jnp`` (the default, as the example runs it) draws the
RandP masks from that stream; ``pallas`` and ``fused`` run the wire
kernels.  Training keeps the config's ``flash_attention`` (on by
default, as in the example), so every layer's attention runs the
flash-attention kernels forward and backward.

    PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.fl_train --full --dsc \\
        --impl jnp --rounds 2
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import random, resolve_device
from repro_torch.configs import get_config
from repro_torch.convert import tree_leaves
from repro_torch.core.compressors import RandP
from repro_torch.core.fl import FLConfig, FLRun
from repro_torch.data import lm_token_batches
from repro_torch.models import transformer as tr


def client_tokens(seed: int, K: int, batch: int, seq_len: int, vocab: int,
                  device=None):
    """The example's clients' tokens, (K, batch, seq_len) int32:
    ``lm_token_batches(fold_in(PRNGKey(seed), 1), ...)``."""
    return lm_token_batches(random.fold_in(random.PRNGKey(seed), 1), K,
                            batch, seq_len, vocab, device=device)


def model_config(arch: str, full: bool):
    """The config at full width or its smoke size, as the example takes
    it: ``flash_attention`` stays the config's (True by default)."""
    cfg = get_config(arch)
    return cfg if full else cfg.smoke()


def fl_config(args) -> FLConfig:
    """The round of the example: eris over K clients and A aggregators;
    with --dsc, RandP(p=0.25) shift compression (the example's RandP(1.0)
    without), through the ``--impl`` kernel path."""
    return FLConfig(method="eris", K=args.K, A=args.A, rounds=args.rounds,
                    lr=args.lr, use_dsc=args.dsc,
                    compressor=RandP(p=0.25 if args.dsc else 1.0),
                    int8_wire=args.int8_wire, compress_impl=args.impl,
                    seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="eris-gptneo-1.3b")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--A", type=int, default=8)
    ap.add_argument("--dsc", action="store_true")
    ap.add_argument("--int8-wire", action="store_true")
    ap.add_argument("--impl", default="jnp",
                    choices=("jnp", "pallas", "fused"),
                    help="DSC path: the threefry RandP of the reference's "
                         "default, the dsc_update kernel, or the fused "
                         "dsc_quantize kernel (int8 wire)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--full", action="store_true",
                    help="the config's full width (default: its smoke size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.full)
    params0 = tr.init_params(cfg, seed=args.seed, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params0))
    fl_cfg = fl_config(args)
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M dtype={cfg.dtype} "
          f"K={args.K} A={args.A} dsc={args.dsc} int8_wire={args.int8_wire} "
          f"impl={args.impl} device={device}", flush=True)

    toks = client_tokens(args.seed, args.K, args.batch, args.seq, cfg.vocab,
                         device)
    eval_toks = lm_token_batches(
        random.fold_in(random.PRNGKey(args.seed), 2), 1, 8, args.seq,
        cfg.vocab, device=device)[0]

    def loss_fn(params, batch):
        return tr.loss_fn(params, cfg, {"tokens": batch})

    run = FLRun(fl_cfg, params0, loss_fn, device=device)
    del params0
    ppl0 = float(np.exp(run.evaluate(eval_toks)))
    t0 = time.monotonic()
    for t in range(args.rounds):
        run.step(toks)
        if t % 20 == 0 or t == args.rounds - 1:
            ppl = float(np.exp(run.evaluate(eval_toks)))
            print(f"round {t:4d}  eval_ppl={ppl:9.2f}  "
                  f"({time.monotonic() - t0:.0f}s)", flush=True)
    print(json.dumps({"ppl_init": ppl0, "ppl_final": ppl,
                      "rounds": args.rounds,
                      "client_losses_last_round": [
                          float(x) for x in run.client_losses[-1]]}))
    return run


if __name__ == "__main__":
    main()
