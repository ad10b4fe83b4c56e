"""Privacy-audit harness (``repro/privacy/harness.py``; Figs. 2, 5, 12 as
a subsystem).

Runs the attack suites of ``repro_torch.core.privacy`` against captured
adversary views -- the ``(T, A, K, n)`` per-aggregator shard views of
``FLConfig.keep_views`` and ``FLRun.run_scanned(collect_views=True)`` --
for the small-model (MLP) problems of the paper's figures and for
transformers of the config zoo (token-sequence canaries for the MIA
audit, input-embedding reconstruction for DLG through ``forward(
inputs_embeds=...)``).

Everything is keyed on an :class:`AuditSpec`.  The draws are the
reference's threefry stream (``repro_torch.random``): the canaries and
the MLP's Gaussian inputs and weights equal the reference's, the
Gaussians to a few ulps (``random.normal``).  A transformer's params come
from ``init_params`` on the reference's key (its threefry draws, within
``normal``'s ulps); a caller may pass its own as ``params0``.  Every entry
point runs on the CUDA card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.convert import (ravel_params, tree_leaves, tree_map,
                                 tree_unflatten)
from repro_torch.core import masks as masks_lib
from repro_torch.core import privacy
from repro_torch.core.compressors import Identity, Int8RoundTrip, RandP
from repro_torch.core.dsc import fma_shift
from repro_torch.core.fl import FLConfig, FLRun


@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """One privacy-audit configuration (a point on a leakage curve)."""

    A: int = 4                 # aggregators
    rounds: int = 30           # T
    K: int = 4                 # clients
    n_canaries: int = 8        # members == non-members == n_canaries
    use_dsc: bool = False      # DSC shifted compression on the wire
    int8_wire: bool = False    # int8 wire round trip in the payload
    p: float = 1.0             # DSC RandP retention (Fig. 2 right)
    a_c: int = 1               # colluding coalition size (Cor. D.2)
    q: float = 1.0             # per-round client participation prob.
    lr: float = 0.4
    seed: int = 0
    mask_scheme: str = "strided"
    n_bootstrap: int = 200     # bootstrap resamples for the AUC CI
    shard_attack: bool = False  # spread the canary gradients over an
                                # attack_mesh of devices


def fl_config(spec: AuditSpec) -> FLConfig:
    """The eris run whose views the audit attacks: literal FSA with
    materialized aggregator views, composing DSC and/or the int8 wire as
    the production wire does.  ``q < 1`` switches to the buffered async
    engine (``eris_async``) with i.i.d. Bernoulli(q) arrivals: a skipped
    round's view is identically zero (amplification by subsampling)."""
    comp = RandP(p=spec.p) if (spec.use_dsc and spec.p < 1.0) else Identity()
    method = "eris" if spec.q >= 1.0 else "eris_async"
    extra = {} if spec.q >= 1.0 else {"client_dropout": 1.0 - spec.q}
    return FLConfig(method=method, K=spec.K, A=spec.A, rounds=spec.rounds,
                    lr=spec.lr, seed=spec.seed, use_dsc=spec.use_dsc,
                    int8_wire=spec.int8_wire, compressor=comp,
                    mask_scheme=spec.mask_scheme, keep_views=True, **extra)


def capture_run(spec: AuditSpec, params0, loss_fn, client_batches,
                device: DeviceLike = None):
    """Run T rounds and capture the adversary views.  Returns (run,
    x_traj (T, n) pre-round iterates, views (T, A, K, n))."""
    run = FLRun(fl_config(spec), params0, loss_fn, device=device)
    stacked = tree_map(lambda b: torch.stack([b] * spec.rounds),
                       client_batches)
    x0 = run.x.clone()
    xs, views = run.run_scanned(stacked, collect_views=True)
    x_traj = torch.cat([x0[None], xs[:-1]], dim=0)
    return run, x_traj, views


def coalition_views(views: torch.Tensor, assign: torch.Tensor, a_c: int,
                    client: int = 0):
    """(obs_mask, observed view trajectory) for the union of the first
    ``a_c`` aggregators' views of one client (Cor. D.2 coalition)."""
    obs = masks_lib.union_mask(assign, list(range(a_c)))
    v = views[:, :a_c, client, :].sum(dim=1)        # (T, n) disjoint union
    return obs, v


def dsc_gamma_of(run: FLRun) -> float:
    """Effective DSC step of the run's compress stage (0.0 without DSC)."""
    from repro_torch.core.pipeline import DSCCompress
    for st in run.pipeline.compress:
        if isinstance(st, DSCCompress):
            return st.gamma
    return 0.0


def deshift_views(v_tn: torch.Tensor, gamma: float,
                  inplace: bool = False) -> torch.Tensor:
    """Protocol-aware adversary against DSC: the client shift updates
    s_{t+1} = s_t + gamma v_t from transmitted values only (s_0 = 0), so
    an aggregator reconstructs, coordinate-wise on its own mask, the
    un-shifted payload g~_t = v_t + gamma * sum_{tau<t} v_tau exactly --
    shifted compression re-codes the wire, it does not hide the gradient
    from a curious aggregator.  Identity when gamma == 0.  The shift
    update is one f32 FMA, as XLA compiles the reference's scan body
    (``core.dsc.fma_shift``).  ``inplace`` overwrites ``v_tn`` (at full
    width the trajectory is not held twice)."""
    if gamma == 0.0:
        return v_tn
    out = v_tn if inplace else torch.empty_like(v_tn)
    s = torch.zeros_like(v_tn[0])
    for t in range(v_tn.shape[0]):
        s_next = fma_shift(gamma, v_tn[t], s)
        torch.add(v_tn[t], s, out=out[t])
        s = s_next
        del s_next
    return out


def flat_grad(loss: Callable, unravel: Callable,
              create_graph: bool = False) -> Callable:
    """``grad_fn(x, *args)``: the gradient of ``loss(unravel(x), *args)``
    with respect to the flat x, in x's dtype (``jax.grad`` through
    ``ravel_pytree``'s unravel).  The gradient is taken leaf by leaf and
    concatenated once: through x's slices, autograd would scatter every
    leaf into a zeroed n-vector of its own.  With ``create_graph`` the
    gradient keeps its graph (DLG differentiates it again)."""
    def grad_fn(x: torch.Tensor, *args) -> torch.Tensor:
        tree = unravel(x.detach())
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
        with torch.enable_grad():
            value = loss(tree_unflatten(tree, leaves), *args)
            grads = torch.autograd.grad(value, leaves,
                                        create_graph=create_graph)
        del tree, leaves, value
        return torch.cat([g.reshape(-1).to(x.dtype) for g in grads])
    return grad_fn


# ------------------------------------------------------- MLP (Fig. 2/5)
def mlp_model(dim: int = 8, classes: int = 3, hidden: int = 16,
              device: DeviceLike = None):
    """(init(key), loss_fn(params, (x, y))) of the tanh MLP."""
    device = resolve_device(device)

    def init(key):
        k1, k2 = random.split(key)
        return {"w1": 0.3 * random.normal(k1, (dim, hidden), device=device),
                "b1": torch.zeros(hidden, device=device),
                "w2": 0.3 * random.normal(k2, (hidden, classes),
                                          device=device),
                "b2": torch.zeros(classes, device=device)}

    def loss_fn(p, batch):
        xx, yy = batch
        h = torch.tanh(xx @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        return -F.log_softmax(logits, dim=-1).gather(
            1, yy.long()[:, None]).mean()

    return init, loss_fn


def mlp_canary_problem(spec: AuditSpec, dim: int = 8, classes: int = 3,
                       hidden: int = 16, device: DeviceLike = None):
    """Steinke-style one-run canary setup: OOD Gaussian inputs with
    random labels; the first half of each client's canaries train (client
    0's are the members, memorized), the second half is held out.
    Returns (params0, loss_fn, batches, members, non-members); a canary
    row is its input with its label appended."""
    device = resolve_device(device)
    key = random.PRNGKey(spec.seed)
    M = spec.n_canaries
    init, loss_fn = mlp_model(dim, classes, hidden, device)
    x = random.normal(random.fold_in(key, 2), (spec.K, 2 * M, dim),
                      device=device)                             # OOD
    y_can = random.randint(random.fold_in(key, 3), (spec.K, 2 * M), 0,
                           classes, device=device)
    batches = (x[:, :M], y_can[:, :M])
    members = torch.cat([x[0, :M], y_can[0, :M, None].float()], dim=1)
    non = torch.cat([x[0, M:], y_can[0, M:, None].float()], dim=1)
    return init(key), loss_fn, batches, members, non


def _mlp_grad_fn(run: FLRun, loss_fn: Callable) -> Callable:
    return flat_grad(lambda p, c: loss_fn(p, (c[:-1][None],
                                              c[-1][None].long())),
                     run.unravel)


def _audit_captured(spec: AuditSpec, run, x_traj, views, grad_fn,
                    members, non, key_salt: int) -> dict:
    """The shared audit plumbing: coalition union -> protocol-aware
    de-shift -> ``mia_audit`` -> Thm 3.3 bound (one definition for every
    model family)."""
    assign = masks_lib.make_assignment(run.n, spec.A, spec.mask_scheme,
                                       device=views.device)
    obs, v = coalition_views(views, assign, spec.a_c)
    v = deshift_views(v, dsc_gamma_of(run))
    mesh = None
    if spec.shard_attack:
        mesh = privacy.attack_mesh(
            members.shape[0],
            None if run.device.type == "cuda" else [run.device])
    res = privacy.mia_audit(
        random.fold_in(random.PRNGKey(spec.seed), key_salt), grad_fn,
        x_traj, v, obs, members, non, n_bootstrap=spec.n_bootstrap,
        mesh=mesh)
    # amplification by subsampling: each round leaks with prob. q, so
    # the linear-in-T Thm 3.3 budget scales by the participation rate
    res["mi_bound"] = spec.q * privacy.mi_bound(
        run.n, spec.rounds, spec.p if spec.use_dsc else 1.0, spec.A,
        a_c=spec.a_c)
    return res


def mia_mlp(spec: AuditSpec, dim: int = 8, classes: int = 3,
            device: DeviceLike = None) -> dict:
    """MIA audit of the captured views under ``spec``: the ``mia_audit``
    metrics and the matching Thm 3.3 bound."""
    params0, loss_fn, batches, members, non = mlp_canary_problem(
        spec, dim, classes, device=device)
    run, x_traj, views = capture_run(spec, params0, loss_fn, batches,
                                     device=device)
    return _audit_captured(spec, run, x_traj, views,
                           _mlp_grad_fn(run, loss_fn), members, non, 0xA0D1)


def mia_mlp_sampling(spec: AuditSpec, q_grid, dim: int = 8,
                     classes: int = 3, device: DeviceLike = None) -> dict:
    """The MIA audit at fixed A as a function of the per-round
    participation probability q (q = 1 the synchronous engine, q < 1 the
    buffered async engine).  Returns {q: mia_mlp metrics}."""
    return {float(q): mia_mlp(dataclasses.replace(spec, q=float(q)),
                              dim=dim, classes=classes, device=device)
            for q in q_grid}


def mia_mlp_collusion_sweep(spec: AuditSpec, dim: int = 8,
                            classes: int = 3,
                            device: DeviceLike = None) -> dict:
    """One captured run, the whole Cor. D.2 collusion curve: the audit
    over the coalition unions a_c = 1..A (``mia_audit_sweep``).  Returns
    arrays indexed by a_c - 1."""
    params0, loss_fn, batches, members, non = mlp_canary_problem(
        spec, dim, classes, device=device)
    run, x_traj, views = capture_run(spec, params0, loss_fn, batches,
                                     device=device)
    assign = masks_lib.make_assignment(run.n, spec.A, spec.mask_scheme,
                                       device=views.device)
    gamma = dsc_gamma_of(run)
    masks, vs = [], []
    for a_c in range(1, spec.A + 1):
        obs, v = coalition_views(views, assign, a_c)
        masks.append(obs)
        vs.append(deshift_views(v, gamma))
    out = privacy.mia_audit_sweep(
        random.fold_in(random.PRNGKey(spec.seed), 0xC011),
        _mlp_grad_fn(run, loss_fn), x_traj, torch.stack(vs),
        torch.stack(masks), members, non, n_bootstrap=spec.n_bootstrap)
    out["a_c"] = np.arange(1, spec.A + 1)
    return out


def _wire(wire: str, key: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The observed payload of a gradient: itself ('f32'), or its
    dequantized per-block int8 round trip ('int8')."""
    if wire == "int8":
        return Int8RoundTrip(inner=Identity())(key, g)
    if wire == "f32":
        return g
    raise ValueError(f"unknown wire format {wire!r}")


def dlg_mlp(A_values, wire: str = "f32", seed: int = 0, dim: int = 36,
            classes: int = 3, steps: int = 400, lr: float = 0.05,
            device: DeviceLike = None) -> dict:
    """DLG inversion strength vs A for one wire format ('f32' or 'int8':
    the dequantized per-block round trip, what an aggregator receives).
    Returns {A: scale-invariant MSE}."""
    runs, target = dlg_mlp_runs(A_values, wire, seed, dim, classes, steps,
                                lr, device)
    return {A: privacy.reconstruction_mse(rec["reconstruction"], target)
            for A, rec in runs.items()}


def dlg_mlp_runs(A_values, wire: str = "f32", seed: int = 0, dim: int = 36,
                 classes: int = 3, steps: int = 400, lr: float = 0.05,
                 device: DeviceLike = None):
    """:func:`dlg_mlp`'s attacks themselves: ({A: ``dlg_attack``'s
    reconstruction and match losses}, the true input)."""
    device = resolve_device(device)
    key = random.PRNGKey(seed)
    k1, k2, k3, k4 = random.split(key, 4)
    params0 = {"w": 0.5 * random.normal(k1, (dim, classes), device=device),
               "b": torch.zeros(classes, device=device)}
    x_flat, unravel = ravel_params(params0)

    def loss_single(p, inp, label):
        return -F.log_softmax(inp @ p["w"] + p["b"], dim=-1)[label]

    grad_fn = flat_grad(loss_single, unravel, create_graph=True)
    target = random.normal(k2, (dim,), device=device)
    label = 1
    g_wire = _wire(wire, k4, grad_fn(x_flat, target, label).detach())
    out = {}
    for A in A_values:
        assign = masks_lib.make_assignment(x_flat.numel(), A, "strided",
                                           device=device)
        obs = masks_lib.mask_for(assign, 0)
        out[A] = privacy.dlg_attack(k3, grad_fn, x_flat, g_wire * obs, obs,
                                    (dim,), label, steps=steps, lr=lr)
    return out, target


# ------------------------------------- transformer family (config zoo)
def tiny_lm_config(arch: str = "qwen2-0.5b"):
    """A CPU-sized member of the config zoo's family (one block below
    ``smoke()``), small enough that (T, A, K, n) view capture fits in a
    quick test.  flash_attention is pinned off, as the reference's: the
    audit's curves were captured on the chunked-attention gradient path,
    and DLG's second derivative cannot go through the flash kernels
    (their backward is once differentiable)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).smoke()
    return dataclasses.replace(
        cfg, name=cfg.name + "-audit", n_layers=1, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab=256, qkv_bias=False,
        qk_norm=False, attn_chunk=16, flash_attention=False,
        overlap_collectives=False)


def lm_canary_problem(cfg, spec: AuditSpec, seq: int = 16, params0=None,
                      device: DeviceLike = None):
    """Token-sequence canaries for a transformer: random sequences, the
    member half trains as client 0's corpus (low-data memorization
    regime), the non-member half is held out.  ``params0`` defaults to
    the reference's ``init_params(PRNGKey(spec.seed))``."""
    from repro_torch.models import transformer as tr
    device = resolve_device(device)
    key = random.PRNGKey(spec.seed)
    M = spec.n_canaries
    canaries = random.randint(random.fold_in(key, 1), (2 * M, seq), 0,
                              cfg.vocab, device=device)
    filler = random.randint(random.fold_in(key, 2), (spec.K - 1, M, seq),
                            0, cfg.vocab, device=device)
    batches = {"tokens": torch.cat([canaries[None, :M], filler], dim=0)}
    if params0 is None:
        params0 = tr.init_params(cfg, seed=spec.seed, device=device)

    def loss_fn(p, batch):
        return tr.loss_fn(p, cfg, batch)

    return params0, loss_fn, batches, canaries[:M], canaries[M:]


def mia_lm(cfg, spec: AuditSpec, seq: int = 16, params0=None,
           device: DeviceLike = None) -> dict:
    """MIA audit against a transformer's captured views (canary = token
    sequence; gradient alignment on the ravelled parameter vector)."""
    from repro_torch.models import transformer as tr
    params0, loss_fn, batches, members, non = lm_canary_problem(
        cfg, spec, seq, params0, device)
    run, x_traj, views = capture_run(spec, params0, loss_fn, batches,
                                     device=device)
    grad_fn = flat_grad(lambda p, c: tr.loss_fn(p, cfg, {"tokens": c[None]}),
                        run.unravel)
    return _audit_captured(spec, run, x_traj, views, grad_fn, members,
                           non, 0xA0D2)


def dlg_lm(cfg, A_values, wire: str = "f32", seed: int = 0, seq: int = 8,
           steps: int = 200, lr: float = 0.05, params0=None,
           device: DeviceLike = None) -> dict:
    """DLG against a transformer: reconstruct the continuous input
    embeddings of one training sequence from the observed (masked,
    wire-formatted) parameter gradient via ``forward(inputs_embeds=...)``.
    ``params0`` defaults to the reference's ``init_params(fold_in(
    PRNGKey(seed), 1))``.  Returns {A: scale-invariant MSE vs the true
    embeddings}."""
    runs, emb_true = dlg_lm_runs(cfg, A_values, wire, seed, seq, steps, lr,
                                 params0, device)
    return {A: privacy.reconstruction_mse(rec["reconstruction"][0],
                                          emb_true)
            for A, rec in runs.items()}


def dlg_lm_runs(cfg, A_values, wire: str = "f32", seed: int = 0,
                seq: int = 8, steps: int = 200, lr: float = 0.05,
                params0=None, device: DeviceLike = None):
    """:func:`dlg_lm`'s attacks themselves: ({A: ``dlg_attack``'s
    reconstruction and match losses}, the true embeddings)."""
    from repro_torch.models import transformer as tr
    device = resolve_device(device)
    key = random.PRNGKey(seed)
    if params0 is None:
        params0 = tr.init_params(cfg, device=device,
                                 key=random.fold_in(key, 1))
    x_flat, unravel = ravel_params(params0)
    tokens = random.randint(random.fold_in(key, 2), (1, seq), 0, cfg.vocab,
                            device=device)
    emb_true = params0["embed"][tokens[0]]
    grad_fn = flat_grad(
        lambda p, dummy, toks: tr.loss_fn(
            p, cfg, {"tokens": toks, "inputs_embeds": dummy}),
        unravel, create_graph=True)
    g_wire = _wire(wire, random.fold_in(key, 3),
                   grad_fn(x_flat, emb_true[None], tokens).detach())
    out = {}
    for A in A_values:
        assign = masks_lib.make_assignment(x_flat.numel(), A, "strided",
                                           device=device)
        obs = masks_lib.mask_for(assign, 0)
        out[A] = privacy.dlg_attack(random.fold_in(key, 4), grad_fn,
                                    x_flat, g_wire * obs, obs,
                                    (1, seq, cfg.d_model), tokens,
                                    steps=steps, lr=lr)
    return out, emb_true
