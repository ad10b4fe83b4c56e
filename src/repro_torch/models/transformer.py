"""Decoder: parameter spec / init / train and prefill forward / the LM
loss / the dense ring-cache decode / paged decode
(``repro/models/transformer.py``, its replicated path).

Parameters keep the reference's layout: every per-layer weight is
stacked along a leading L axis, so converting a JAX checkpoint is a
leaf-for-leaf copy (``repro_torch.convert``).  The reference scans the
layer axis with ``lax.scan``; here a Python loop walks it.

Families, as the reference's ``_block``: the dense decoder (and
``audio`` and ``vlm``, whose language models are the same dense stack;
vlm prepends projected image-patch embeddings), ``moe`` (the FFN swapped
for the routed experts of ``models/moe.py``), ``ssm`` (the mLSTM mixer
and a gated projection, ``models/ssm.py``) and ``hybrid`` (attention and
a selective-SSM head in parallel, averaged).  Training (``mode="train"``,
``loss_fn``) runs through PyTorch autograd.  Its attention is routed as
the reference routes it: with ``cfg.flash_attention`` (the default)
every shape that the 128-blocks tile goes through the flash-attention
kernels (``kernels/flash_attention``, a ``torch.autograd.Function``
whose backward is the dq and dk/dv kernels); any other shape, and
prefill, through the plain chunked ``causal_attention``.  Decode runs
one token against the dense ring cache (``init_cache``,
``decode_step``) or, for the paged families, against the block pools
(``paged_decode_step``).

The model axis (``tp``, a :class:`TPRuntime`): ``forward`` and
``loss_fn`` run on this rank's parameter shards under the family's
:class:`TPPlan` (``models/shard_plan``), with the reference's regions
placed where its ``tp`` branches place them: head-sharded attention (the
flash kernels at the TP-local head counts), the ring (context) attention
where heads do not divide, the sharded FFN, the channel-sharded mamba
head and the head-sharded mLSTM, the vocab-parallel embedding and the CE
on vocab-sharded logits, the expert-parallel MoE, and sequence
parallelism.  The collectives are ``models/layers``' conjugates.

The pipe axis (``pipe``, a :class:`PipeRuntime`): ``pipeline_loss_fn``
runs this rank's stage, the block rows it holds, over the reference's
1F1B wavefront of m + p - 1 ticks, the carry shipped one stage forward
each tick.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.dist import collectives as cl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import accounting
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_plan import (PipeRuntime,  # noqa: F401
                                           TPPlan, TPRuntime, tp_plan)

# the dtypes the paged kernel takes, for params and for the cache
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# init_params' window on the host: its int64 temporaries (128 KB) are
# reused by the allocator, where 2**24-element ones are fresh pages each
# op (on one thread, about twice as fast)
HOST_WINDOW = 1 << 14


# ============================================================ param spec
def param_spec(cfg: ModelConfig) -> dict:
    """Shapes of every parameter, as the reference's ``param_spec``: the
    order of the leaves is the order of their ``fold_in`` indices."""
    D, V, Lyr = cfg.d_model, cfg.vocab, cfg.n_layers
    F_, Q, KV, hd, H = cfg.d_ff, cfg.q_dim, cfg.kv_dim, cfg.hd, cfg.n_heads
    blk: dict[str, tuple] = {"ln1": (Lyr, D), "ln2": (Lyr, D)}
    if cfg.family != "ssm":
        blk.update(wq=(Lyr, D, Q), wk=(Lyr, D, KV), wv=(Lyr, D, KV),
                   wo=(Lyr, Q, D))
        if cfg.qkv_bias:
            blk.update(bq=(Lyr, Q), bk=(Lyr, KV), bv=(Lyr, KV))
        if cfg.qk_norm:
            blk.update(q_norm=(Lyr, hd), k_norm=(Lyr, hd))
    if cfg.family == "moe":
        E = cfg.n_experts
        blk.update(router=(Lyr, D, E), w_gate=(Lyr, E, D, F_),
                   w_up=(Lyr, E, D, F_), w_down=(Lyr, E, F_, D))
    elif cfg.family == "ssm":
        blk.update(xq=(Lyr, D, Q), xk=(Lyr, D, Q), xv=(Lyr, D, Q),
                   xo=(Lyr, Q, D), w_i=(Lyr, D, H), w_f=(Lyr, D, H),
                   b_i=(Lyr, H), b_f=(Lyr, H),
                   p_up=(Lyr, D, 2 * D), p_gate=(Lyr, D, 2 * D),
                   p_down=(Lyr, 2 * D, D))
    elif cfg.family == "hybrid":
        Di, N = D, cfg.ssm_state
        blk.update(m_in=(Lyr, D, 2 * Di), m_dt=(Lyr, D, Di),
                   m_bc=(Lyr, D, 2 * N), m_A=(Lyr, Di, N),
                   m_D=(Lyr, Di), m_out=(Lyr, Di, D), m_ln=(Lyr, Di),
                   w_gate=(Lyr, D, F_), w_up=(Lyr, D, F_),
                   w_down=(Lyr, F_, D))
    else:                                   # dense / audio / vlm
        blk.update(w_gate=(Lyr, D, F_), w_up=(Lyr, D, F_),
                   w_down=(Lyr, F_, D))
    spec = {"embed": (V, D), "ln_f": (D,), "blocks": blk}
    if not cfg.tie_embeddings:
        spec["lm_head"] = (D, V)
    if cfg.frontend == "vlm":
        spec["proj_in"] = (cfg.d_frontend, D)
    return spec


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None, *,
                key: Optional[torch.Tensor] = None) -> dict:
    """The reference's ``init_params(PRNGKey(seed), cfg)`` (or
    ``init_params(key, cfg)`` when a threefry ``key`` is given), made on
    ``device``: norm scales ones; biases and hybrid's skip ``m_D``
    zeros; hybrid's ``m_A`` log(1..N) in every row, with no draw; every
    matrix
    ``normal(fold_in(key, i), shape, f32) * f32(fan_in ** -0.5)`` cast to
    the config's dtype, leaf i in ``param_spec`` order, fan_in the
    second-to-last dim.  The threefry draws are jax's bits; ``normal``'s
    erfinv agrees with XLA's to a few ulps.  Each leaf is drawn a window
    at a time into its final dtype, so no leaf-sized int64 or f32
    temporary is held: ``random.CHUNK`` elements on a card; on the host
    :data:`HOST_WINDOW`, on one thread (:func:`_one_thread`).

    As the reference's, the ssm forget bias ``b_f`` is 0: its
    ``name.startswith("b")`` catches ``b_f`` before the branch that
    would set it to 2.0."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    key = random.PRNGKey(seed) if key is None else key
    window = random.CHUNK if device.type == "cuda" else HOST_WINDOW

    def one(idx, name, shape):
        if name.startswith(("ln", "q_norm", "k_norm", "m_ln")):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.startswith("b") or name == "m_D":
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "m_A":
            # the S4D-real init log(1..N), on the host: numpy's f32 log
            # gives XLA's bits for these (torch's, correctly rounded,
            # differs at log 7 by an ulp)
            rows = torch.from_numpy(np.log(np.arange(1, shape[-1] + 1,
                                                     dtype=np.float32)))
            return rows.expand(shape).to(dtype).to(device)
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


def _ring(cfg: ModelConfig, tp) -> int:
    """The model-axis size when the ring collectives are on (0 takes the
    plain all-reduce conjugates)."""
    return tp.size if (tp is not None and cfg.overlap_collectives) else 0


# ================================================================= blocks
def _qkv(cfg: ModelConfig, lp: dict, h: torch.Tensor, positions,
         n_heads: Optional[int] = None, n_kv: Optional[int] = None):
    B, S = h.shape[:2]
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, n_heads or cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, n_kv or cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, n_kv or cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def _attn_ctx(cfg: ModelConfig, lp: dict, x, positions, window, tp,
              seq: bool):
    """The context-parallel (ring) attention region (``:139-172``): the
    sequence, not the heads, shards over the model axis.  Weights are
    replicated (their gradients partial); each rank projects q/k/v for
    its S/n chunk and the K/V chunks rotate around the ring.  Under a seq
    plan the residual stream already is the chunk; otherwise ``ctx_enter``
    and ``ctx_exit`` slice and reassemble it."""
    B = x.shape[0]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if not seq:
        h = L.ctx_enter(h, tp)
    C = h.shape[1]
    cpos = positions[:, tp.index * C:(tp.index + 1) * C]
    q, k, v = _qkv(cfg, lp, h, cpos)
    out = L.ring_attention(q, k, v, tp, window=window)
    y = out.reshape(B, C, cfg.n_heads * cfg.hd) @ lp["wo"]
    if not seq:
        y = L.ctx_exit(y, tp)
    return x + y, None


def _attn(cfg: ModelConfig, lp: dict, x, positions, window, mode: str,
          cache: Optional[dict] = None, pos: Optional[int] = None,
          tp: Optional[TPRuntime] = None):
    """Attention with its residual (``models/transformer.py:175-253``).
    A training shape that ``uses_flash_kernel`` goes through the flash
    kernels on (B, H, S, hd) views of the projections, read in place;
    prefill and any other training shape through the plain chunked
    ``causal_attention``.  ``mode="decode"`` writes the new K/V into
    ``cache`` (one layer's (B, size, KV, hd) ring, IN PLACE) at slot
    ``pos % size`` under a window, else ``pos``, and attends over it.
    Returns (x_out, {"k", "v"}): the layer's prefill K/V, or its cache.

    With ``tp``: the ring region where the plan says ``ctx`` and the
    sequence divides; else the heads shard (``plan.attn``: the flash
    kernels at the TP-local head counts), entered with ``tp_enter`` or,
    under ``seq``, the sequence gather; a replicated region under ``seq``
    keeps this rank's slice of its output."""
    tp_attn = tp is not None and tp.plan.attn
    seq = tp is not None and tp.plan.seq
    if (tp is not None and tp.plan.ctx > 1 and mode == "train"
            and window != 0
            and (x.shape[1] * (tp.size if seq else 1)) % tp.size == 0):
        return _attn_ctx(cfg, lp, x, positions, window, tp, seq)
    n_heads = cfg.n_heads // (tp.size if tp_attn else 1)
    n_kv = cfg.n_kv_heads // (tp.size if tp_attn else 1)
    B = x.shape[0]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if seq:
        h = L.tp_seq_gather(h, tp, 1)
    elif tp_attn:
        h = L.tp_enter(h, tp, _ring(cfg, tp))
    S = h.shape[1]
    q, k, v = _qkv(cfg, lp, h, positions, n_heads, n_kv)
    if mode == "decode":
        size = cache["k"].shape[1]
        slot = pos % size if window is not None else pos
        if slot >= size:
            raise ValueError(f"decode_step at position {pos} past a cache "
                             f"of {size} positions (no window)")
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        out = L.decode_attention(q, cache["k"], cache["v"], pos,
                                 window=window)
        kv = cache
    elif mode == "train" and uses_flash_kernel(cfg, S, window):
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=window).transpose(1, 2)
        kv = None
    else:
        out = L.causal_attention(
            q, k, v, window=window, chunk=cfg.attn_chunk,
            scores_f32=cfg.attn_scores_f32 and not cfg.bf16_residency)
        kv = {"k": k, "v": v} if mode == "prefill" else None
    y = out.reshape(B, S, n_heads * cfg.hd) @ lp["wo"]
    if seq and tp_attn:
        y = L.tp_seq_scatter(y, tp, 1)         # partials -> seq shards
    elif seq:
        # the replicated region under a seq plan: every rank computed the
        # whole output; keep this rank's slice (the entry gather's
        # reduce-scatter assembles the slices' cotangents)
        s_loc = S // tp.size
        y = y[:, tp.index * s_loc:(tp.index + 1) * s_loc]
    elif tp_attn:
        y = L.tp_exit(y, tp, _ring(cfg, tp))
    return x + y, kv


def _gated_mlp(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def _ffn(cfg: ModelConfig, lp: dict, x, tp: Optional[TPRuntime] = None):
    """The block's FFN with its residual: the gated MLP (``:260-273``:
    column/row sharded under ``plan.ffn``, through the sequence
    conjugates under ``seq``), or for moe the routed experts (``:400-406``,
    expert-parallel under ``plan.moe``).  Returns (x, aux), aux holding
    moe's ``load_balance`` and ``dropped_frac``."""
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"],
                                 lp["w_down"], top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 group=cfg.moe_group_size, tp=tp)
        return x + y, aux
    tp_ffn = tp is not None and tp.plan.ffn
    seq = tp is not None and tp.plan.seq       # seq plans imply tp_ffn
    if seq:
        h = L.tp_seq_gather(h, tp, 1)
    elif tp_ffn:
        h = L.tp_enter(h, tp, _ring(cfg, tp))
    y = _gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    if seq:
        y = L.tp_seq_scatter(y, tp, 1)
    elif tp_ffn:
        y = L.tp_exit(y, tp, _ring(cfg, tp))
    return x + y, {}


def _mamba(cfg: ModelConfig, lp: dict, x, mode: str, state=None,
           tp: Optional[TPRuntime] = None):
    """The selective-SSM head of a hybrid block (``:276-315``), on the
    un-normed residual x.  Returns (its output, the new state: the
    scan's h_final in prefill, the step's h in decode, else None).

    Under ``plan.mixer`` the channels shard: m_dt/m_A/m_D/m_ln/m_out hold
    this rank's channels and the scan runs local; m_in and m_bc stay
    replicated (partial gradients), z and u cut to the local channels;
    m_ln's mean of squares is a both-ways psum."""
    D = x.shape[-1]
    tp_mix = tp is not None and tp.plan.mixer
    if tp_mix:
        x = L.tp_push(x, tp)
    z, u = (x @ lp["m_in"]).chunk(2, -1)
    dt = F.softplus(x @ lp["m_dt"])
    Bm, Cm = (x @ lp["m_bc"]).chunk(2, -1)
    if tp_mix:
        d_loc = dt.shape[-1]                   # m_dt is column-sharded
        z = z[..., tp.index * d_loc:(tp.index + 1) * d_loc]
        u = u[..., tp.index * d_loc:(tp.index + 1) * d_loc]
    u = F.silu(u)
    if mode == "decode":
        h_new, y = ssm_lib.ssm_decode_step(
            state, u[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], lp["m_A"],
            lp["m_D"])
        y = y[:, None]
    else:
        y, h_new = ssm_lib.ssm_scan(u, dt, Bm, Cm, lp["m_A"], lp["m_D"],
                                    chunk=cfg.scan_chunk,
                                    scan_f32=cfg.ssm_scan_f32)
        h_new = h_new if mode == "prefill" else None
    if tp_mix:
        y = L.rms_norm_sharded(y, lp["m_ln"], cfg.norm_eps, tp, D)
    else:
        y = L.rms_norm(y, lp["m_ln"], cfg.norm_eps)
    out = (y * F.silu(z)) @ lp["m_out"]
    return (L.tp_pull(out, tp) if tp_mix else out), h_new


def init_mlstm_state(cfg: ModelConfig, B: int, device: DeviceLike = None,
                     heads: Optional[int] = None):
    """The mLSTM's empty state (``:366``): C, n zeros and m = -1e30, f32,
    of the config's heads or, under a head-sharded mixer, a rank's
    ``heads``."""
    device = resolve_device(device)
    H, hd = heads or cfg.n_heads, cfg.hd
    return {"C": torch.zeros(B, H, hd, hd, device=device),
            "n": torch.zeros(B, H, hd, device=device),
            "m": torch.full((B, H), -1e30, device=device)}


def _mlstm(cfg: ModelConfig, lp: dict, x, mode: str, state=None,
           tp: Optional[TPRuntime] = None):
    """The mLSTM mixer with its residual (``:318-363``).  Prefill builds
    the recurrent state by replaying ``mlstm_decode_step`` over the
    prompt, as the reference does.  Returns (x_out, the new state or
    None in training).  Under ``plan.mixer`` the heads shard (xq/xk/xv
    and the gates column-parallel, xo row-parallel) and the recurrence
    runs local."""
    B, S = x.shape[:2]
    tp_mix = tp is not None and tp.plan.mixer
    H = cfg.n_heads // (tp.size if tp_mix else 1)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if tp_mix:
        h = L.tp_push(h, tp)
    q, k, v = ((h @ lp[n]).reshape(B, S, H, cfg.hd)
               for n in ("xq", "xk", "xv"))
    i_pre = h @ lp["w_i"] + lp["b_i"]
    f_pre = h @ lp["w_f"] + lp["b_f"]
    new_state = None
    if mode == "decode":
        new_state, out = ssm_lib.mlstm_decode_step(
            state, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
        out = out[:, None]
    else:
        out = ssm_lib.mlstm_parallel(q, k, v, i_pre, f_pre,
                                     chunk=cfg.attn_chunk,
                                     scores_f32=cfg.attn_scores_f32)
        if mode == "prefill":
            new_state = init_mlstm_state(cfg, B, x.device, H)
            for t in accounting.trips(range(S), x.device):
                new_state, _ = ssm_lib.mlstm_decode_step(
                    new_state, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                    f_pre[:, t])
    y = out.reshape(B, S, H * cfg.hd) @ lp["xo"]
    if tp_mix:
        y = L.tp_pull(y, tp)
    return x + y, new_state


def _block(cfg: ModelConfig, lp: dict, x, positions, window, mode: str,
           cache: Optional[dict] = None, pos: Optional[int] = None,
           tp: Optional[TPRuntime] = None):
    """One layer (``:373-411``).  Returns (x, the layer's cache in
    prefill and decode, aux)."""
    if cfg.family == "ssm":
        x, mix = _mlstm(cfg, lp, x, mode, cache["mix"] if cache else None,
                        tp)
        tp_ffn = tp is not None and tp.plan.ffn
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if tp_ffn:                      # the gated in-block projection pair
            h = L.tp_push(h, tp)
        y = _gated_mlp(h, lp["p_gate"], lp["p_up"], lp["p_down"])
        if tp_ffn:
            y = L.tp_pull(y, tp)
        return x + y, {"mix": mix}, {}
    if cfg.family == "hybrid":
        attn_out, kv = _attn(cfg, lp, x, positions, window, mode,
                             cache["kv"] if cache else None, pos, tp)
        m_out, m_state = _mamba(cfg, lp, x, mode,
                                cache["ssm"] if cache else None, tp)
        x = 0.5 * (attn_out + (x + m_out))  # parallel heads, averaged
        x, _ = _ffn(cfg, lp, x, tp)
        return x, {"kv": kv, "ssm": m_state}, {}
    x, kv = _attn(cfg, lp, x, positions, window, mode,
                  cache["kv"] if cache else None, pos, tp)
    x, aux = _ffn(cfg, lp, x, tp)
    return x, {"kv": kv}, aux


# ================================================================ forward
def embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None,
                 tp: Optional[TPRuntime] = None):
    """Token embedding; vlm prepends its projected image-patch embeddings
    (``frontend_embeds`` (B, n_frontend_tokens, d_frontend) @
    ``proj_in``), and without them raises, where the reference's assert
    fails.  The lookup's gradient is a scatter-add of the rows; the
    reference's one-hot matmul backward (``dense_embed_grad``) gives the
    same values up to the order of summation.

    Under a vocab-parallel plan each rank holds rows [index V/tp,
    (index + 1) V/tp): a token out of its range looks up zero, and the
    exit (or under ``seq`` the reduce-scatter into sequence shards)
    assembles the embedding."""
    x = embed_tokens(params, cfg, tokens, tp)
    if cfg.frontend == "vlm":
        if frontend_embeds is None:
            raise ValueError(
                f"{cfg.name} (vlm) embeds an image before its text: pass "
                f"frontend_embeds (B, {cfg.n_frontend_tokens}, "
                f"{cfg.d_frontend}), the image's patch embeddings (the "
                f"reference fails at this call too, and serves no vlm)")
        img = frontend_embeds.to(x.dtype) @ params["proj_in"]
        x = torch.cat([img, x], 1)
    return x


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 tp: Optional[TPRuntime] = None):
    """The token lookup of :func:`embed_inputs`, with no image: what a
    decode step embeds (a vlm's image lives in the prefilled prefix)."""
    if tp is not None and tp.plan.vocab:
        v_loc = cfg.vocab // tp.size
        idx = tokens.long() - tp.index * v_loc
        ok = (idx >= 0) & (idx < v_loc)
        x = torch.where(ok[..., None],
                        params["embed"][idx.clamp(0, v_loc - 1)], 0)
        if tp.plan.seq:
            x = L.tp_seq_scatter(x, tp, 1)
        else:
            x = L.tp_exit(x, tp, _ring(cfg, tp))
    else:
        x = params["embed"][tokens.long()]
    return x


def uses_flash_kernel(cfg: ModelConfig, seq_len: int,
                      window: Optional[int] = None) -> bool:
    """Whether the reference trains this shape through its Pallas flash
    attention (``models/transformer.py:223-225`` with ``supports``)."""
    return (cfg.flash_attention and not cfg.attn_batch_shard
            and window != 0 and fa.supports(seq_len, cfg.hd))


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            mode: str = "prefill", window: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            tp: Optional[TPRuntime] = None):
    """Full-sequence forward.  Returns (logits, caches, aux).

    ``mode="prefill"`` runs without autograd and returns the reference's
    stacked per-layer caches: ``{"kv": {"k", "v"}}`` (L, B, S, KV, hd)
    for the attention families, ``{"mix": {"C", "n", "m"}}`` (L, B, ...)
    for ssm, ``{"kv", "ssm": h_final (L, B, d_model, N)}`` for hybrid;
    ``mode="train"`` records the graph for the backward and returns no
    caches; its attention goes through the flash kernels where the
    reference's does (:func:`uses_flash_kernel`).  One token against a
    cache is :func:`decode_step`.

    ``frontend_embeds`` (B, n_frontend_tokens, d_frontend) are vlm's
    image-patch embeddings, prepended to the text; the positions and the
    flash gate take the joint length.  ``inputs_embeds`` (B, S, D)
    replaces the embedding (the image prefix included): the continuous
    input that the DLG gradient inversion optimizes
    (``repro_torch.privacy``); ``tokens`` still gives the targets.

    With ``tp`` the params are this rank's shards under ``tp.plan``;
    under a vocab-parallel plan the logits come back vocab-sharded (B, S,
    V/tp), for ``loss_fn``'s sharded CE.  Under ``seq`` the residual
    stream between regions is (B, S/tp, D) and the unembed gathers the
    sequence; ``seq_ce`` (ssm, hybrid) runs the final norm on this rank's
    sequence chunk.  ``inputs_embeds`` is the replicated path's hook
    only."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"forward(mode={mode!r}): want prefill or train; "
                         f"one token against a cache is decode_step")
    if mode == "prefill":
        with torch.no_grad():
            return _forward(params, cfg, tokens, window, mode,
                            inputs_embeds, frontend_embeds, tp)
    return _forward(params, cfg, tokens, window, mode, inputs_embeds,
                    frontend_embeds, tp)


def _forward(params, cfg, tokens, window, mode: str, inputs_embeds,
             frontend_embeds, tp=None):
    seq = tp is not None and tp.plan.seq
    if seq and tokens.shape[1] % tp.size != 0:
        raise ValueError(
            f"sequence-parallel plan needs seq_len divisible by the "
            f"model axis: {tokens.shape[1]} % {tp.size} != 0")
    if inputs_embeds is None:
        x = embed_inputs(params, cfg, tokens, frontend_embeds, tp)
    elif tp is not None:
        raise ValueError("inputs_embeds is a replicated-path hook "
                         "(attack/simulator side); tp must be None")
    else:
        x = inputs_embeds
    B = x.shape[0]
    S = x.shape[1] * (tp.size if seq else 1)    # the full sequence
    positions = torch.arange(S, device=x.device).expand(B, S)
    caches, lb = [], []
    for lp in _layers(params):
        x, cache, aux = _block(cfg, lp, x, positions, window, mode, tp=tp)
        lb.append(aux.get("load_balance",
                          torch.zeros((), device=x.device)))
        if mode == "prefill":
            caches.append(cache)
    logits = _unembed(params, cfg, x, tp, seq, mode)
    # the reference's scan stacks each layer's load_balance and means it
    return (logits, _stack(caches) if mode == "prefill" else None,
            {"load_balance": torch.stack(lb).mean()})


def _unembed(params, cfg, x, tp, seq: bool, mode: str = "train"):
    """The forward's tail from the residual stream to the logits: the
    final norm, and under a vocab plan the column-parallel unembed's
    entry; shared by ``forward`` and ``pipeline_loss_fn``'s last stage.

    seq_ce (ssm, hybrid, whose residual stream stays replicated): the
    final norm on this rank's chunk, entered by a slice whose backward
    assembles the chunks' cotangents, left into the unembed by the
    sequence gather (reduce-scatter backward): ln_f's gradient partial."""
    seq_ce = (tp is not None and tp.plan.seq_ce and not seq
              and mode == "train" and x.shape[1] % tp.size == 0)
    if seq_ce:
        x = L.ctx_enter(x, tp)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if tp is not None and tp.plan.vocab:
        x = (L.tp_seq_gather(x, tp, 1) if (seq or seq_ce)
             else L.tp_enter(x, tp, _ring(cfg, tp)))
    return x @ _head(params, cfg)


def _stack(trees: list):
    """Per-layer cache trees stacked leaf by leaf on a leading L axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _select_logit(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """pred[..., tgt]: value- and gradient-identical to the reference's
    one-hot masked sum (exactly one nonzero term per row)."""
    return pred.gather(-1, tgt.long()[..., None])[..., 0]


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            window: Optional[int] = None,
            tp: Optional[TPRuntime] = None) -> torch.Tensor:
    """Causal LM loss.  batch: dict(tokens (B, S) [, loss_mask (B, S)] [,
    inputs_embeds (B, S, D)] [, frontend_embeds (B, n_frontend_tokens,
    d_frontend)]).  Next-token CE with f32 logits unless the config keeps
    them in the compute dtype; vlm predicts its text tokens only.

    ``tp=None`` is the replicated path.  With a :class:`TPRuntime` the
    forward runs on this rank's shards and, under a vocab-parallel plan,
    the CE on vocab-sharded logits: the max over the model axis of the
    stop-gradient max, the sum of exponentials and the target logit
    assembled by the exit conjugate, so each rank's backward touches only
    its own columns."""
    tokens = batch["tokens"]
    logits, _, aux = forward(params, cfg, tokens, "train", window,
                             inputs_embeds=batch.get("inputs_embeds"),
                             frontend_embeds=batch.get("frontend_embeds"),
                             tp=tp)
    nll = _ce(cfg, logits, tokens, batch.get("loss_mask"), tp)
    if cfg.family == "moe":
        nll = nll + 0.01 * aux["load_balance"]
    return nll


def _ce(cfg: ModelConfig, logits, tokens, loss_mask, tp=None):
    """Masked next-token CE from (under a vocab plan, vocab-sharded)
    logits (``:603-648``)."""
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0
    logits = logits[:, n_pre:, :]
    targ = tokens[:, 1:]
    fp32_logits = cfg.loss_fp32_logits and not cfg.bf16_residency
    if tp is not None and tp.plan.vocab:
        v_loc = cfg.vocab // tp.size
        pred = logits[:, :-1]
        if fp32_logits:
            pred = pred.float()
        m = L.pmax(pred.max(-1).values, tp)
        e = torch.exp(pred - m[..., None])
        lse = m.float() + torch.log(L.tp_exit(
            e.sum(-1, dtype=torch.float32), tp, _ring(cfg, tp)))
        idx = targ.long() - tp.index * v_loc
        ok = (idx >= 0) & (idx < v_loc)
        ll_loc = _select_logit(pred, idx.clamp(0, v_loc - 1))
        ll = L.tp_exit(torch.where(ok, ll_loc, 0).float(), tp,
                       _ring(cfg, tp))
    elif fp32_logits:
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


def pipeline_loss_fn(params: dict, cfg: ModelConfig, batch: dict,
                     window: Optional[int] = None,
                     tp: Optional[TPRuntime] = None,
                     pipe: Optional[PipeRuntime] = None) -> torch.Tensor:
    """Causal LM loss with the layer stack split into ``pipe.plan.size``
    contiguous stages and the batch into ``pipe.plan.microbatches``
    slices (``:651-758``); without an active pipe plan, ``loss_fn``.

    ``params["blocks"]`` holds this stage's L/p layer rows, every other
    leaf whole.  The m + p - 1 wavefront ticks each ship the carry one
    stage forward (``layers.shift_next``), inject on stage 0 the
    embedding of microbatch clip(t, 0, m - 1), run this stage's rows, and
    take the CE of microbatch clip(t - (p - 1), 0, m - 1), which entered
    p - 1 ticks earlier.  Autograd replays the wavefront in reverse, the
    interleaved 1F1B order of ``shard_plan.pipeline_schedule``.

    Every stage runs the same program, so that every rank calls the same
    collectives in the same order both ways: the injection and the CE run
    on every stage at every tick and are selected by ``torch.where`` on
    tensor conditions (the reference's ``valid_here`` and ``valid_out``),
    never by a branch on the stage; tick 0 ships a zero carry with no
    gradient on every stage.  The loss is the last stage's sum of
    per-microbatch means, assembled over the pipe group by ``tp_pull``
    (each stage's backward gets the same 1/m) and divided by m; for moe
    the load-balance term is each stage's valid ticks' layer means summed
    over the pipe group, / (p m).  With a ``loss_mask``, or for moe, that
    is not ``loss_fn``'s value: the reference's ``pipeline_loss_fn``
    defines it.

    The carry is the embedding's dtype (the reference's is the config's:
    a bf16 config's f32 params after adam would change its scan's carry
    type) and (mb, (S + n_pre) / tp, D) under a sequence-parallel plan.
    The reference remats its block body; recomputing changes no value, so
    the port keeps the activations."""
    if pipe is None or not pipe.plan.active:
        return loss_fn(params, cfg, batch, window, tp)
    p, m = pipe.plan.size, pipe.plan.microbatches
    tokens = batch["tokens"]
    B, S = tokens.shape
    if B % m != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {m}")
    mb = B // m
    seq = tp is not None and tp.plan.seq
    tok_mb = tokens.reshape(m, mb, S)
    mask = batch.get("loss_mask")
    mask_mb = mask.reshape(m, mb, S) if mask is not None else None
    fe = batch.get("frontend_embeds")
    fe_mb = fe.reshape(m, mb, *fe.shape[1:]) if fe is not None else None
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0
    S_h = (S + n_pre) // (tp.size if seq else 1)      # the carry's length
    dev = tokens.device
    positions = torch.arange(S + n_pre, device=dev).expand(mb, S + n_pre)
    stage = pipe.index
    layers = _layers(params)

    def flag(cond: bool) -> torch.Tensor:
        return torch.tensor(cond, device=dev)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x_prev = torch.zeros((mb, S_h, cfg.d_model),
                         dtype=params["embed"].dtype, device=dev)
    loss_sum, lb_sum = zero, zero
    for t in range(m + p - 1):
        # the boundary send: last tick's activation, one stage forward
        recv = L.shift_next(x_prev, pipe)
        j_in = min(max(t, 0), m - 1)
        inj = embed_inputs(params, cfg, tok_mb[j_in],
                           fe_mb[j_in] if fe_mb is not None else None, tp)
        x = torch.where(flag(stage == 0), inj, recv)
        lbs = []
        for lp in layers:
            x, _, aux = _block(cfg, lp, x, positions, window, "train", tp=tp)
            lbs.append(aux.get("load_balance", zero))
        # stage s holds microbatch t - s at ticks s <= t < s + m
        valid_here = flag(stage <= t < stage + m)
        lb_sum = lb_sum + torch.where(valid_here, torch.stack(lbs).mean(),
                                      zero)
        # what leaves the last stage now entered p - 1 ticks ago
        j_out = min(max(t - (p - 1), 0), m - 1)
        logits = _unembed(params, cfg, x, tp, seq)
        nll = _ce(cfg, logits, tok_mb[j_out],
                  mask_mb[j_out] if mask_mb is not None else None, tp)
        valid_out = flag(stage == p - 1 and p - 1 <= t < p - 1 + m)
        loss_sum = loss_sum + torch.where(valid_out, nll, zero)
        x_prev = x
    loss = L.tp_pull(loss_sum, pipe) / m
    if cfg.family == "moe":
        loss = loss + 0.01 * L.tp_pull(lb_sum, pipe) / (p * m)
    return loss


# ================================================================= decode
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               window: Optional[int] = None, dtype=torch.bfloat16,
               device: DeviceLike = None) -> dict:
    """Per-layer stacked dense decode caches (``:762-776``): the mLSTM
    state for ssm; else K/V rings (L, batch, size, KV, hd) of ``dtype``,
    size = min(window, cache_len) under a window, and for hybrid the SSM
    state (L, batch, d_model, N) f32."""
    device = resolve_device(device)
    Lyr = cfg.n_layers
    if cfg.family == "ssm":
        st = init_mlstm_state(cfg, batch, device)
        return {"mix": {k: v.expand(Lyr, *v.shape).clone()
                        for k, v in st.items()}}
    size = min(window, cache_len) if window else cache_len
    shape = (Lyr, batch, size, cfg.n_kv_heads, cfg.hd)
    kv = {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        ssm = torch.zeros(Lyr, batch, cfg.d_model, cfg.ssm_state,
                          device=device)
        return {"kv": kv, "ssm": ssm}
    return {"kv": kv}


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: int,
                window: Optional[int] = None, donate: bool = False):
    """One new token per sequence against the dense cache (``:779-800``).

    token: (B, 1) int; pos: the new token's absolute position (a Python
    int, shared by the batch).  The caller's cache is left as it was:
    the K/V rings are copied once and written in place, the recurrent
    states made anew.  With ``donate`` the caller's K/V rings are written
    in place and returned, as the reference's jit with ``donate_argnums``
    reuses them (the serving dry run's step holds one cache, not two).
    Returns (logits (B, 1, V), new cache).

    A K/V cache whose dtype would promote the residual stream (an f32
    cache under bf16 params) raises, where the reference's layer scan
    fails on its carry's changed dtype: keep the cache in the params'
    dtype or below."""
    x = params["embed"][token.long()]
    if "kv" in cache and torch.promote_types(
            x.dtype, cache["kv"]["k"].dtype) != x.dtype:
        raise ValueError(
            f"decode_step: a {cache['kv']['k'].dtype} K/V cache would turn "
            f"the {x.dtype} residual stream {cache['kv']['k'].dtype} (the "
            f"reference's layer scan fails on it); make the cache in "
            f"{x.dtype}")
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    kv = ({n: t if donate else t.clone() for n, t in cache["kv"].items()}
          if "kv" in cache else None)
    states = []
    for i, lp in enumerate(_layers(params)):
        layer = {}
        if kv is not None:
            layer["kv"] = {n: t[i] for n, t in kv.items()}
        if "mix" in cache:
            layer["mix"] = {n: t[i] for n, t in cache["mix"].items()}
        if "ssm" in cache:
            layer["ssm"] = cache["ssm"][i]
        x, new, _ = _block(cfg, lp, x, positions, window, "decode", layer,
                           pos)
        states.append({k: v for k, v in new.items() if k != "kv"})
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    new_cache = _stack(states)
    if kv is not None:
        new_cache["kv"] = kv
    return x @ _head(params, cfg), new_cache


# ========================================================== paged decode
# The serving engine's cache is a global pool of fixed-size blocks
# (serve/cache.py); each request owns a block table.  Every row of the
# decode step carries its OWN absolute position, K/V write through the
# block table, and attention reads through it (the CUDA kernel in
# kernels/paged_attention, or its plain torch version).

def paged_families() -> tuple:
    """Families the paged decode path serves (pure K/V caches; the
    recurrent ssm and hybrid states are per request, served by
    :func:`decode_step`).  vlm is listed, as the reference lists it, but
    its prefill needs an image that neither engine passes."""
    return ("dense", "moe", "audio", "vlm")


def init_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None,
                     kv_heads: Optional[int] = None) -> dict:
    """Per-layer stacked K/V block pools: (L, N, KV, bs, hd), KV the
    config's kv heads or a model position's ``kv_heads``
    (``dist/sharding.paged_pool_heads``)."""
    if cfg.family not in paged_families():
        raise ValueError(
            f"paged KV cache supports families {paged_families()}, not "
            f"{cfg.family!r}")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, kv_heads or cfg.n_kv_heads,
             block_size, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_paged(cfg: ModelConfig, lp: dict, x, positions, k_pool, v_pool,
                block_tables, ctx_lens, window, use_kernel: bool,
                tp: Optional[TPRuntime] = None):
    """One layer's attention against its (N, KV, bs, hd) pools.  x: (B, 1,
    D); positions/ctx_lens: (B, 1)/(B,) -- the new token's absolute
    position.  Writes the new K/V into the pools IN PLACE, then attends.

    Under ``tp.plan.attn`` (``:812-866``) wq/wk/wv/wo and the pools hold
    this rank's heads: the kernel runs on (B, H/tp, hd) queries against
    (N, KV/tp, bs, hd) pools, and the row-parallel ``wo`` partials are
    summed over the model group.  Otherwise the region runs whole on
    every rank."""
    tp_attn = tp is not None and tp.plan.attn
    n_heads = cfg.n_heads // (tp.size if tp_attn else 1)
    n_kv = cfg.n_kv_heads // (tp.size if tp_attn else 1)
    B = x.shape[0]
    bs = k_pool.shape[2]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions, n_heads, n_kv)
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
    y = out.reshape(B, 1, n_heads * cfg.hd) @ lp["wo"]
    if tp_attn:
        y = L.tp_pull(y, tp)                # row-parallel wo partials
    return x + y


@torch.no_grad()
def paged_decode_step(params: dict, cfg: ModelConfig, pools: dict,
                      block_tables: torch.Tensor,
                      context_lens: torch.Tensor, tokens: torch.Tensor,
                      window: Optional[int] = None,
                      use_kernel: bool = True,
                      tp: Optional[TPRuntime] = None):
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

    With ``tp`` (``:869-931``) the params are this rank's TP pieces and,
    under ``tp.plan.attn``, the pools hold its kv heads: the embedding is
    vocab-parallel, attention and the FFN (dense or the expert-parallel
    MoE) run their TP regions, and under ``tp.plan.vocab`` the logits of
    the column-parallel unembed are gathered over the model group, so
    they come back FULL for the row-wise sampler.  The plan should be
    decode-safe (no ``seq``, ``seq_ce`` or ``ctx``): one token has no
    sequence to shard.

    The new tokens are embedded without an image (:func:`embed_tokens`):
    a vlm's image is in the prefilled prefix, where the reference's step
    asks ``embed_inputs`` for one and fails.
    """
    x = embed_tokens(params, cfg, tokens, tp)
    positions = context_lens[:, None]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = _attn_paged(cfg, lp, x, positions, pools["k"][i], pools["v"][i],
                        block_tables, context_lens, window, use_kernel, tp)
        x, _ = _ffn(cfg, lp, x, tp)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    if tp is not None and tp.plan.vocab:
        logits = cl.all_gather(logits, tp.group, 2)
    return logits, pools
