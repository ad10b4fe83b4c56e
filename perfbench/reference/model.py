"""A plain decoder LM and its loss, in float32 torch: the model of the
configurations' ``model`` block, written from the published equations
and independent of the code under test.

Layer: x += Wo attn(rope(Wq h), rope(Wk h), Wv h), h = rmsnorm(x);
x += ffn(rmsnorm(x)), ffn the gated MLP down(silu(gate h) * up h) or,
for ``family == "moe"``, the routed experts: tokens cut into groups of
``moe_group_size``; in a group each token picks its ``top_k`` experts by
softmax probability (ties to the lower expert), the gates renormalised
to sum 1; an expert takes at most capacity = int(capacity_factor *
top_k * group / E) choices in token-major order and drops the rest; the
output is the gate-weighted sum of the kept experts' gated MLPs.  The
loss is the mean next-token cross entropy, plus for moe 0.01 times the
layers' mean Switch load-balance term E * sum_e f_e P_e (f_e the share
of a group's tokens choosing e, P_e its mean probability, groups
weighted by their token share).  RMSnorm: x * rsqrt(mean(x**2) + eps)
* scale; RoPE rotates the two halves of each head against each other
(theta = ``rope_theta``); attention is causal softmax(q k^T / sqrt(hd)).

The loss of a batch is a sum of per-row terms (routing groups never
straddle rows when the group divides the row), so the gradient is taken
one row at a time: what fits beside the round's state at full width.

``fp8=True`` is the control: every product takes its inputs rounded to
float8 e4m3 with one scale per tensor (amax / 448) and, in the backward,
the incoming gradient rounded to e5m2 (amax / 57344), computed in f32
from there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX, E5M2_MAX = 448.0, 57344.0
ATTN_BLOCK = 512


def param_spec(m: dict) -> dict:
    """Shapes of every weight, per-layer leaves stacked on a leading
    layer axis."""
    D, V, L = m["d_model"], m["vocab"], m["n_layers"]
    hd = m.get("head_dim") or D // m["n_heads"]
    Q, KV, Fd = m["n_heads"] * hd, m["n_kv_heads"] * hd, m["d_ff"]
    blk = {"ln1": (L, D), "ln2": (L, D), "wq": (L, D, Q), "wk": (L, D, KV),
           "wv": (L, D, KV), "wo": (L, Q, D)}
    if m.get("qkv_bias"):
        blk.update(bq=(L, Q), bk=(L, KV), bv=(L, KV))
    if m.get("qk_norm"):
        blk.update(q_norm=(L, hd), k_norm=(L, hd))
    if m["family"] == "moe":
        E = m["n_experts"]
        blk.update(router=(L, D, E), w_gate=(L, E, D, Fd),
                   w_up=(L, E, D, Fd), w_down=(L, E, Fd, D))
    elif m["family"] == "dense":
        blk.update(w_gate=(L, D, Fd), w_up=(L, D, Fd), w_down=(L, Fd, D))
    else:
        raise ValueError(f"the reference has no family {m['family']!r}")
    spec = {"embed": (V, D), "ln_f": (D,), "blocks": blk}
    if not m.get("tie_embeddings"):
        spec["lm_head"] = (D, V)
    return spec


# ------------------------------------------------------------ products
def _q(x: torch.Tensor, dtype, top: float) -> tuple:
    """x rounded to ``dtype`` under one scale: (the codes, the scale)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x.detach() / scale).to(dtype), scale


def _f32(q: tuple) -> torch.Tensor:
    return q[0].float() * q[1]


class _MatmulFP8(torch.autograd.Function):
    """a @ b from e4m3 inputs; the backward's products from the saved
    e4m3 codes and the incoming gradient in e5m2 (the codes are kept, a
    quarter of the f32 inputs' bytes)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q(a, torch.float8_e4m3fn, E4M3_MAX), \
            _q(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa[0], qa[1], qb[0], qb[1])
        return _f32(qa) @ _f32(qb)

    @staticmethod
    def backward(ctx, grad):
        a8, sa, b8, sb = ctx.saved_tensors
        g8 = _f32(_q(grad, torch.float8_e5m2, E5M2_MAX))
        ga = g8 @ _f32((b8, sb)).transpose(-1, -2)
        gb = _f32((a8, sa)).transpose(-1, -2) @ g8
        # undo broadcasting over leading dims
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


class Products:
    """The model's matrix products, in f32 or through the fp8 control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, a, b):
        return _MatmulFP8.apply(a, b) if self.fp8 else a @ b


# -------------------------------------------------------------- layers
def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (S, H, hd), positions 0..S-1."""
    S, _, hd = x.shape
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attn_block(mm, q, k, v, start):
    """Queries [start, start + bq) of one row against every key; q:
    (H, bq, hd), k, v: (H, S, hd)."""
    bq, S = q.shape[1], k.shape[1]
    s = mm(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(start, start + bq, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return mm(torch.softmax(s, -1), v)


def attention(mm, q, k, v):
    """Causal attention of one row, (S, H, hd) each, a block of queries
    at a time under a checkpoint: no (H, S, S) tensor is kept."""
    H, KV = q.shape[1], k.shape[1]
    q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    if KV != H:
        k = k.repeat_interleave(H // KV, 0)
        v = v.repeat_interleave(H // KV, 0)
    S = q.shape[1]
    outs = [checkpoint(_attn_block, mm, q[:, lo:lo + ATTN_BLOCK], k, v, lo,
                       use_reentrant=False)
            for lo in range(0, S, ATTN_BLOCK)]
    return torch.cat(outs, 1).transpose(0, 1)


def gated_mlp(mm, h, wg, wu, wd):
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def moe(mm, m, h, router, wg, wu, wd):
    """The routed experts of one row, h: (T, D).  Returns (y, the row's
    load-balance sum over its groups)."""
    T, D = h.shape
    E, k = m["n_experts"], m["top_k"]
    group = min(m["moe_group_size"], T)
    if T % group:
        raise ValueError(f"a row of {T} tokens in groups of {group}")
    G = T // group
    cap = max(1, int(m["capacity_factor"] * k * group / E))
    probs = torch.softmax(mm(h, router), -1).view(G, group, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]                 # (G, t, k)
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, E)                               # (G,t,k,E)
    flat = onehot.reshape(G, group * k, E)
    pos = (torch.cumsum(flat, 1) - flat).reshape(onehot.shape)
    pos = (pos * onehot).sum(-1)                             # (G, t, k)
    kept = pos < cap
    # each kept choice's slot in the (E, G, cap) expert batches
    g_idx = torch.arange(G, device=h.device)[:, None, None].expand_as(idx)
    t_idx = (torch.arange(T, device=h.device).view(G, group, 1)
             .expand_as(idx))
    slot = (idx * G + g_idx) * cap + pos
    slot, tok, gate = slot[kept], t_idx[kept], gates[kept]
    xe = torch.zeros(E * G * cap, D, dtype=h.dtype, device=h.device)
    xe = xe.index_copy(0, slot, h[tok]).view(E, G * cap, D)
    ye = mm(F.silu(mm(xe, wg)) * mm(xe, wu), wd).reshape(E * G * cap, D)
    y = torch.zeros_like(h).index_add(0, tok, ye[slot] * gate[:, None])
    density = onehot.sum(2).float().mean(1)                  # (G, E)
    lb = (E * (density * probs.mean(1)).sum(-1)).sum()
    return y, lb


def _layer(m: dict, mm: Products, blk: dict, i: int, x: torch.Tensor):
    """Layer i on the residual stream x (S, D): (x out, its load-balance
    sum, 0 for a dense layer)."""
    eps, theta = m["norm_eps"], m["rope_theta"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    S = x.shape[0]
    h = rms_norm(x, blk["ln1"][i], eps)
    q, kk, v = (mm(h, blk[n][i]) for n in ("wq", "wk", "wv"))
    if m.get("qkv_bias"):
        q, kk, v = q + blk["bq"][i], kk + blk["bk"][i], v + blk["bv"][i]
    q, kk, v = q.view(S, H, hd), kk.view(S, KV, hd), v.view(S, KV, hd)
    if m.get("qk_norm"):
        q = rms_norm(q, blk["q_norm"][i], eps)
        kk = rms_norm(kk, blk["k_norm"][i], eps)
    o = attention(mm, rope(q, theta), rope(kk, theta), v)
    x = x + mm(o.reshape(S, H * hd), blk["wo"][i])
    h = rms_norm(x, blk["ln2"][i], eps)
    if m["family"] == "moe":
        y, lb = moe(mm, m, h, blk["router"][i], blk["w_gate"][i],
                    blk["w_up"][i], blk["w_down"][i])
    else:
        y = gated_mlp(mm, h, blk["w_gate"][i], blk["w_up"][i],
                      blk["w_down"][i])
        lb = torch.zeros((), device=x.device)
    return x + y, lb


def row_loss(m: dict, w: dict, tokens: torch.Tensor, n_rows: int,
             mm: Products) -> torch.Tensor:
    """Row ``tokens`` (S,)'s share of the batch loss over ``n_rows``
    rows: its summed cross entropy / (n_rows (S - 1)), plus for moe 0.01
    times its groups' share of the layers' mean load balance.  Each
    layer runs under a checkpoint: the backward recomputes it from its
    input, so a row keeps one layer's activations at a time."""
    S = tokens.shape[0]
    x = w["embed"][tokens.long()]
    blk = w["blocks"]
    L = len(blk["ln1"])
    lb_total = 0.0
    for i in range(L):
        x, lb = checkpoint(_layer, m, mm, blk, i, x, use_reentrant=False)
        lb_total = lb_total + lb
    head = w["embed"].T if m.get("tie_embeddings") else w["lm_head"]
    logits = mm(rms_norm(x, w["ln_f"], m["norm_eps"]), head)
    nll = F.cross_entropy(logits[:-1], tokens[1:].long(), reduction="sum")
    loss = nll / (n_rows * (S - 1))
    if m["family"] == "moe":
        groups = n_rows * (S // min(m["moe_group_size"], S))
        loss = loss + 0.01 * lb_total / (L * groups)
    return loss
