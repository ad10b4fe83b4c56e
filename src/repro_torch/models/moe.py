"""Mixture-of-Experts FFN with grouped capacity-based dispatch
(``repro/models/moe.py``).

Tokens are cut into groups of ``group``; within a group the router's
top-k choices become a 0/1 dispatch tensor (group, E, capacity) and the
expert computation is three dense products.  A token past its expert's
capacity is dropped; a token count that the group does not divide is
padded with masked tokens that claim no capacity and combine nothing.

The reference's arithmetic is kept where it decides a route or a value:
the router product in the activations' dtype, rounded before the f32
softmax; ``lax.top_k``'s order, ties to the lower expert index (a stable
descending sort; ``torch.topk`` promises no order among ties); the
``gate / max(sum, 1e-9)`` renormalisation; capacity in Python floats;
queue positions by a cumulative sum over the flattened (token, choice)
order, token-major.  The reference builds ``disp`` and ``comb`` by
einsums over one-hot slots, each sum holding at most one nonzero term;
here the same values are scattered into place.

Under an expert-parallel plan (``tp.plan.moe``) the expert dim of
w_gate/w_up/w_down is sharded over the model axis and tokens reach their
experts by an explicit ``all_to_all`` dispatch and combine: the token
groups shard over the axis inside the region (entered with ``tp_push``,
left with a zero-padded ``tp_pull``), each rank routes its own groups
with the replicated router (partial gradients), and the dispatched (g,
E, c, D) slots cross the axis so that every expert computes where its
weights live.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def sorted_top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_tokens(xg: torch.Tensor, router_w: torch.Tensor,
                 valid: torch.Tensor, *, top_k: int, capacity_factor: float,
                 total_valid: Optional[float] = None):
    """Group-local routing: top-k gates -> capacity-limited dispatch.

    xg: (g, t, D) grouped tokens; router_w: (D, E); valid: (g, t) bool,
    False rows (padding) claim no capacity slot and combine no output.
    ``total_valid`` is the count of real tokens across all groups
    (default: this call's valid count).

    Returns ``(disp, comb, aux)``: ``disp`` (g, t, E, c) 0/1 dispatch in
    xg's dtype, ``comb`` (g, t, E, c) combine weights in xg's dtype
    (exactly 0 for dropped and invalid tokens), and the aux terms
    ``load_balance`` and ``dropped_frac`` over valid tokens, each group
    weighted by its share of ``total_valid``."""
    n_groups, group, _ = xg.shape
    E = router_w.shape[-1]
    logits = (xg @ router_w).float()
    probs = torch.softmax(logits, -1)
    gate_vals, idx = sorted_top_k(probs, top_k)             # (g, t, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    vmask = valid.float()                                   # (g, t)
    gate_vals = gate_vals * vmask[..., None]

    cap = max(1, int(capacity_factor * top_k * group / E))
    # each (token, choice)'s place in its expert's queue, token-major;
    # invalid tokens carry a zero one-hot and take no place
    onehot = F.one_hot(idx, E) * valid[..., None, None].long()  # (g,t,k,e)
    flat = onehot.reshape(n_groups, group * top_k, E)
    pos = (torch.cumsum(flat, 1) - flat).reshape(onehot.shape)
    dispatch = onehot * (pos < cap)                         # (g,t,k,e)
    # the one slot each (token, choice) takes, if it is kept; a token's k
    # experts differ, so no two of its choices share a slot
    slot = pos.gather(-1, idx[..., None])[..., 0].clamp(0, cap - 1)
    kept = dispatch.gather(-1, idx[..., None])[..., 0]      # (g, t, k)
    where = idx * cap + slot
    disp = torch.zeros(n_groups, group, E * cap, dtype=xg.dtype,
                       device=xg.device).scatter(-1, where, kept.to(xg.dtype))
    comb = torch.zeros(n_groups, group, E * cap, dtype=torch.float32,
                       device=xg.device).scatter(-1, where, gate_vals * kept)
    disp = disp.view(n_groups, group, E, cap)
    comb = comb.view(n_groups, group, E, cap).to(xg.dtype)

    # Switch load-balance loss E * sum_e f_e * p_e over valid tokens,
    # each group weighted by its valid share
    gcount = torch.clamp_min(vmask.sum(1), 1.0)             # (g,)
    density = onehot.float().sum(2).sum(1) / gcount[:, None]
    p_mean = (probs * vmask[..., None]).sum(1) / gcount[:, None]
    total = torch.clamp_min(
        vmask.sum() if total_valid is None
        else torch.tensor(float(total_valid), device=xg.device), 1.0)
    w_g = vmask.sum(1) / total
    routed = (dispatch.sum((2, 3)) > 0).float() * vmask
    aux = {"load_balance": (w_g * (E * (density * p_mean).sum(-1))).sum(),
           "dropped_frac": (vmask.sum() - routed.sum()) / total}
    return disp, comb, aux


def _expert_ffn(xe, w_gate, w_up, w_down):
    """The three dense expert products on dispatched slots (g, E, c, D)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate)) * \
        torch.einsum("gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25, group: int = 256, tp=None):
    """x: (B, S, D); router_w: (D, E), always the full expert count;
    w_gate/w_up: (E, D, F); w_down: (E, F, D), this rank's expert shard
    (E/tp, ...) under an expert-parallel ``tp`` plan.  Returns ((B, S,
    D), aux).

    Under the plan the tokens are padded to a multiple of ``group * tp``
    (so the groups split evenly over the ranks), each rank routes its
    ``n_groups / tp`` groups with ``total_valid`` the global token count
    (the aux terms are partial sums that the exit all-reduces), and the
    slots cross by ``all_to_all``: split on the expert axis and
    concatenated on the group axis going out, the reverse coming back."""
    B, S, D = x.shape
    ep = tp is not None and tp.plan.moe
    tp_size = tp.size if ep else 1
    T = B * S
    group = min(group, T)
    tile = group * tp_size
    Tp = -(-T // tile) * tile
    xt = x.reshape(T, D)
    if Tp != T:
        xt = F.pad(xt, (0, 0, 0, Tp - T))
    n_groups = Tp // group
    xg = xt.reshape(n_groups, group, D)
    valid = (torch.arange(Tp, device=x.device) < T).reshape(n_groups, group)
    if ep:
        gl = n_groups // tp_size
        start = tp.index * gl
        xg = L.tp_push(xg, tp)[start:start + gl]
        disp, comb, aux = route_tokens(
            xg, router_w, valid[start:start + gl], top_k=top_k,
            capacity_factor=capacity_factor, total_valid=float(T))
        xe = torch.einsum("gtec,gtd->gecd", disp, xg)       # (gl, E, c, D)
        # dispatch: this rank's slots for expert e go to e's owner
        xe = L.all_to_all(xe, tp, 1, 0)                     # (gl tp, E/tp..)
        ye = _expert_ffn(xe, w_gate, w_up, w_down)
        ye = L.all_to_all(ye, tp, 0, 1)                     # (gl, E, c, D)
        y_loc = torch.einsum("gtec,gecd->gtd", comb, ye)
        y = F.pad(y_loc, (0, 0, 0, 0, start, n_groups - start - gl))
        y = L.tp_pull(y, tp)
        aux = {k: L.tp_pull(v, tp) for k, v in aux.items()}
    else:
        disp, comb, aux = route_tokens(xg, router_w, valid, top_k=top_k,
                                       capacity_factor=capacity_factor)
        xe = torch.einsum("gtec,gtd->gecd", disp, xg)       # (g, E, c, D)
        ye = _expert_ffn(xe, w_gate, w_up, w_down)
        y = torch.einsum("gtec,gecd->gtd", comb, ye)
    return y.reshape(Tp, D)[:T].reshape(B, S, D), aux
