"""Decoder: parameter spec / init / train and prefill forward / the LM
loss / paged decode (the dense subset of ``repro/models/transformer.py``).

Parameters keep the reference's layout: every per-layer weight is
stacked along a leading L axis, so converting a JAX checkpoint is a
leaf-for-leaf copy (``repro_torch.convert``).  The reference scans the
layer axis with ``lax.scan``; here a Python loop walks it.

Families: the dense decoder (and ``audio``, whose language model is the
same dense stack) and ``moe``, whose blocks swap the FFN for the routed
experts of ``models/moe.py``.  hybrid, ssm and vlm are ROADMAP queue
1.9.  Training (``mode="train"``, ``loss_fn``)
runs through PyTorch autograd.  Its attention is routed as the
reference routes it: with ``cfg.flash_attention`` (the default) every
shape that the 128-blocks tile goes through the flash-attention kernels
(``kernels/flash_attention``, a ``torch.autograd.Function`` whose
backward is the dq and dk/dv kernels); any other shape, and prefill,
through the plain chunked ``causal_attention``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig

_FAMILIES = ("dense", "audio", "moe")

# the dtypes the paged kernel takes, for params and for the cache
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# init_params' window on the host: its int64 temporaries (128 KB) are
# reused by the allocator, where 2**24-element ones are fresh pages each
# op (on one thread, about twice as fast)
HOST_WINDOW = 1 << 14


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port runs {_FAMILIES}; ssm, hybrid and vlm are ROADMAP "
            f"queue 1.9")


# ============================================================ param spec
def param_spec(cfg: ModelConfig) -> dict:
    """Shapes of every parameter, as the reference's ``param_spec``."""
    _require_family(cfg)
    D, V, Lyr = cfg.d_model, cfg.vocab, cfg.n_layers
    F_, Q, KV, hd = cfg.d_ff, cfg.q_dim, cfg.kv_dim, cfg.hd
    blk: dict[str, tuple] = {"ln1": (Lyr, D), "ln2": (Lyr, D),
                             "wq": (Lyr, D, Q), "wk": (Lyr, D, KV),
                             "wv": (Lyr, D, KV), "wo": (Lyr, Q, D)}
    if cfg.qkv_bias:
        blk.update(bq=(Lyr, Q), bk=(Lyr, KV), bv=(Lyr, KV))
    if cfg.qk_norm:
        blk.update(q_norm=(Lyr, hd), k_norm=(Lyr, hd))
    if cfg.family == "moe":
        E = cfg.n_experts
        blk.update(router=(Lyr, D, E), w_gate=(Lyr, E, D, F_),
                   w_up=(Lyr, E, D, F_), w_down=(Lyr, E, F_, D))
    else:
        blk.update(w_gate=(Lyr, D, F_), w_up=(Lyr, D, F_),
                   w_down=(Lyr, F_, D))
    spec = {"embed": (V, D), "ln_f": (D,), "blocks": blk}
    if not cfg.tie_embeddings:
        spec["lm_head"] = (D, V)
    return spec


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None, *,
                key: Optional[torch.Tensor] = None) -> dict:
    """The reference's ``init_params(PRNGKey(seed), cfg)`` (or
    ``init_params(key, cfg)`` when a threefry ``key`` is given), made on
    ``device``: norm scales ones, biases zeros, and every matrix
    ``normal(fold_in(key, i), shape, f32) * f32(fan_in ** -0.5)`` cast to
    the config's dtype, leaf i in ``param_spec`` order, fan_in the
    second-to-last dim.  The threefry draws are jax's bits; ``normal``'s
    erfinv agrees with XLA's to a few ulps.  Each leaf is drawn a window
    at a time into its final dtype, so no leaf-sized int64 or f32
    temporary is held: ``random.CHUNK`` elements on a card; on the host
    :data:`HOST_WINDOW`, on one thread (:func:`_one_thread`)."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    key = random.PRNGKey(seed) if key is None else key
    window = random.CHUNK if device.type == "cuda" else HOST_WINDOW

    def one(idx, name, shape):
        if name.startswith(("ln", "q_norm", "k_norm")):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.startswith("b"):
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = float(np.float32(fan_in ** -0.5))
        leaf_key = random.fold_in(key, idx)
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), window):
            hi = min(flat.numel(), lo + window)
            flat[lo:hi] = random.normal(leaf_key, shape, device=device,
                                        window=(lo, hi)) * scale
        return out

    params: dict = {}
    idx = 0
    with _one_thread(device):
        for name, shape in param_spec(cfg).items():
            if name == "blocks":
                params["blocks"] = {}
                for bn, bshape in shape.items():
                    params["blocks"][bn] = one(idx, bn, bshape)
                    idx += 1
            else:
                params[name] = one(idx, name, shape)
                idx += 1
    return params


@contextlib.contextmanager
def _one_thread(device: torch.device):
    """torch's host ops on one thread inside, on the host.  A threefry
    draw is ~250 elementwise ops a window, and split over the intra-op
    thread pool each one waits at the pool's barrier: where several such
    processes share the cores (a test runner's workers) the waits
    dominate, by two orders of magnitude."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _layer(params: dict, i: int) -> dict:
    return {n: t[i] for n, t in params["blocks"].items()}


def _layers(params: dict) -> list:
    """Every layer's weights, by one ``unbind`` of each stacked leaf: its
    backward stacks the L per-layer gradients once, where L ``t[i]``
    selects would each scatter into a zeroed full-size (L, ...) gradient
    (at full width, L passes over 3 GB in every backward)."""
    slices = {n: t.unbind(0) for n, t in params["blocks"].items()}
    return [{n: ts[i] for n, ts in slices.items()}
            for i in range(len(next(iter(slices.values()))))]


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ================================================================= blocks
def _qkv(cfg: ModelConfig, lp: dict, h: torch.Tensor, positions):
    B, S = h.shape[:2]
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def _attn(cfg: ModelConfig, lp: dict, x, positions, window, train: bool):
    """Prefill and training attention (``models/transformer.py:175-241``):
    a training shape that ``uses_flash_kernel`` goes through the flash
    kernels on (B, H, S, hd) views of the projections, read in place;
    everything else through the plain chunked ``causal_attention``.
    Returns (x_out, {"k", "v"}) -- the per-layer cache."""
    B, S = x.shape[:2]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    if train and uses_flash_kernel(cfg, S, window):
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=window).transpose(1, 2)
    else:
        out = L.causal_attention(
            q, k, v, window=window, chunk=cfg.attn_chunk,
            scores_f32=cfg.attn_scores_f32 and not cfg.bf16_residency)
    y = out.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"]
    return x + y, {"k": k, "v": v}


def _gated_mlp(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def _ffn(cfg: ModelConfig, lp: dict, x):
    """The block's FFN with its residual: the gated MLP, or for moe the
    routed experts (``models/transformer.py:400-406``).  Returns (x,
    aux), aux holding moe's ``load_balance`` and ``dropped_frac``."""
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"],
                                 lp["w_down"], top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 group=cfg.moe_group_size)
        return x + y, aux
    return x + _gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"]), {}


def _block(cfg: ModelConfig, lp: dict, x, positions, window, train: bool):
    x, kv = _attn(cfg, lp, x, positions, window, train)
    x, aux = _ffn(cfg, lp, x)
    return x, {"kv": kv}, aux


# ================================================================ forward
def embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    """Token embedding.  Its gradient is a scatter-add of the rows; the
    reference's one-hot matmul backward (``dense_embed_grad``) gives the
    same values up to the order of summation."""
    _require_family(cfg)
    return params["embed"][tokens.long()]


def uses_flash_kernel(cfg: ModelConfig, seq_len: int,
                      window: Optional[int] = None) -> bool:
    """Whether the reference trains this shape through its Pallas flash
    attention (``models/transformer.py:223-225`` with ``supports``)."""
    return (cfg.flash_attention and not cfg.attn_batch_shard
            and window != 0 and fa.supports(seq_len, cfg.hd))


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            mode: str = "prefill", window: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward.  Returns (logits, caches, aux).

    ``mode="prefill"`` runs without autograd and returns the per-layer
    K/V stacked as (L, B, S, KV, hd) under ``caches["kv"]``;
    ``mode="train"`` records the graph for the backward and returns no
    caches; its attention goes through the flash kernels where the
    reference's does (:func:`uses_flash_kernel`).

    ``inputs_embeds`` (B, S, D) replaces the token-embedding lookup: the
    continuous input that the DLG gradient inversion optimizes
    (``repro_torch.privacy``); ``tokens`` still gives the positions and
    the targets."""
    if mode == "prefill":
        with torch.no_grad():
            return _forward(params, cfg, tokens, window, keep_cache=True,
                            inputs_embeds=inputs_embeds)
    if mode != "train":
        raise NotImplementedError(
            f"forward(mode={mode!r}): prefill and train are ported; the "
            f"dense ring-cache decode is ROADMAP queue 1.11")
    return _forward(params, cfg, tokens, window, keep_cache=False,
                    inputs_embeds=inputs_embeds)


def _forward(params, cfg, tokens, window, keep_cache: bool,
             inputs_embeds=None):
    if inputs_embeds is None:
        x = embed_inputs(params, cfg, tokens)
    else:
        _require_family(cfg)
        x = inputs_embeds
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs, lb = [], [], []
    for lp in _layers(params):
        x, cache, aux = _block(cfg, lp, x, positions, window,
                               train=not keep_cache)
        lb.append(aux.get("load_balance",
                          torch.zeros((), device=x.device)))
        if keep_cache:
            ks.append(cache["kv"]["k"])
            vs.append(cache["kv"]["v"])
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    caches = ({"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
              if keep_cache else None)
    # the reference's scan stacks each layer's load_balance and means it
    return logits, caches, {"load_balance": torch.stack(lb).mean()}


def _select_logit(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """pred[..., tgt]: value- and gradient-identical to the reference's
    one-hot masked sum (exactly one nonzero term per row)."""
    return pred.gather(-1, tgt.long()[..., None])[..., 0]


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            window: Optional[int] = None) -> torch.Tensor:
    """Causal LM loss (the reference's replicated path, ``tp=None``).
    batch: dict(tokens (B, S) [, loss_mask (B, S)] [, inputs_embeds (B,
    S, D)]).  Next-token CE with f32 logits unless the config keeps them
    in the compute dtype."""
    tokens = batch["tokens"]
    logits, _, aux = forward(params, cfg, tokens, "train", window,
                             inputs_embeds=batch.get("inputs_embeds"))
    nll = _ce(cfg, logits, tokens, batch.get("loss_mask"))
    if cfg.family == "moe":
        nll = nll + 0.01 * aux["load_balance"]
    return nll


def _ce(cfg: ModelConfig, logits, tokens, loss_mask):
    """Masked next-token CE: the two non-sharded branches of the
    reference's ``_ce``."""
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0
    logits = logits[:, n_pre:, :]
    targ = tokens[:, 1:]
    if cfg.loss_fp32_logits and not cfg.bf16_residency:
        pred = logits[:, :-1].float()
        lse = torch.logsumexp(pred, dim=-1)
        ll = _select_logit(pred, targ)
    else:
        # no f32 copy of the (B, S, V) logits: max-shift and exp in the
        # compute dtype, the sum accumulated in f32
        pred = logits[:, :-1]
        m = pred.max(-1).values.detach()
        e = torch.exp(pred - m[..., None])
        lse = m.float() + torch.log(e.sum(-1, dtype=torch.float32))
        ll = _select_logit(pred, targ).float()
    nll = lse - ll
    if loss_mask is not None:
        m = loss_mask[:, 1:]
        return (nll * m).sum() / torch.clamp(m.sum(), min=1)
    return nll.mean()


# ========================================================== paged decode
# The serving engine's cache is a global pool of fixed-size blocks
# (serve/cache.py); each request owns a block table.  Every row of the
# decode step carries its OWN absolute position, K/V write through the
# block table, and attention reads through it (the CUDA kernel in
# kernels/paged_attention, or its plain torch version).

def paged_families() -> tuple:
    """Families the paged decode path serves in the port."""
    return _FAMILIES


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> dict:
    """Per-layer stacked K/V block pools: (L, N, KV, bs, hd)."""
    if cfg.family not in paged_families():
        raise ValueError(
            f"paged KV cache supports families {paged_families()}, not "
            f"{cfg.family!r}")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads, block_size, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_paged(cfg: ModelConfig, lp: dict, x, positions, k_pool, v_pool,
                block_tables, ctx_lens, window, use_kernel: bool):
    """One layer's attention against its (N, KV, bs, hd) pools.  x: (B, 1,
    D); positions/ctx_lens: (B, 1)/(B,) -- the new token's absolute
    position.  Writes the new K/V into the pools IN PLACE, then attends."""
    B = x.shape[0]
    bs = k_pool.shape[2]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    # Write, then attend with ctx + 1: logical position ctx_lens[b] lives
    # at (block_tables[b, ctx // bs], ctx % bs).  Inactive slots (ctx 0,
    # table all scratch) all write to scratch block 0 at offset 0; those
    # duplicate indices are harmless because no live row reads scratch,
    # and accumulate=True would be wrong (it sums the duplicates).
    # pool[pages, :, offs] puts the advanced dims in front: (B, KV, hd).
    rows = torch.arange(B, device=x.device)
    pages = block_tables[rows, (ctx_lens // bs).long()].long()
    offs = (ctx_lens % bs).long()
    k_pool[pages, :, offs] = k[:, 0].to(k_pool.dtype)
    v_pool[pages, :, offs] = v[:, 0].to(v_pool.dtype)
    fn = pa.paged_attention if use_kernel else pa.paged_attention_ref
    out = fn(q[:, 0].contiguous(), k_pool, v_pool, block_tables,
             ctx_lens + 1, window=window)
    y = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ lp["wo"]
    return x + y


@torch.no_grad()
def paged_decode_step(params: dict, cfg: ModelConfig, pools: dict,
                      block_tables: torch.Tensor,
                      context_lens: torch.Tensor, tokens: torch.Tensor,
                      window: Optional[int] = None,
                      use_kernel: bool = True):
    """One decode step for a batch of requests at DIFFERENT positions.

    tokens: (B, 1) -- each row's newest token
    context_lens: (B,) int32 -- tokens already cached per row (the new
        token's absolute position); inactive rows pass 0 with a
        scratch-block table and produce garbage logits that the engine
        masks out
    pools: ``init_paged_pools`` dict; block_tables: (B, P) int32

    The reference returns new pools (JAX donates the old ones to jit);
    here the pools are updated in place and the same dict is returned.
    ``use_kernel`` selects :func:`paged_attention` (the CUDA kernel on a
    CUDA tensor) over its plain version.  Returns (logits (B, 1, V), pools).
    """
    x = embed_inputs(params, cfg, tokens)
    positions = context_lens[:, None]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = _attn_paged(cfg, lp, x, positions, pools["k"][i], pools["v"][i],
                        block_tables, context_lens, window, use_kernel)
        x, _ = _ffn(cfg, lp, x)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ _head(params, cfg), pools
