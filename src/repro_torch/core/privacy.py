"""Privacy analysis and attacks (``repro/core/privacy.py``: Theorem 3.3,
Corollary D.2, Section 4.1).

* ``mi_bound``      -- the information-theoretic bound
                       I <= n T p A_c / A * C_max
* ``gaussian_cmax`` -- the Gaussian instantiation C_max <= 1/2 log(1+SNR)
* ``mia_audit``     -- Steinke-style one-run canary auditing: a gradient
                       alignment attacker restricted to the coordinates
                       the adversary (an aggregator, or a coalition of
                       a_c of them) observes, with a bootstrap confidence
                       interval on AUC and balanced accuracy keyed on the
                       audit key
* ``mia_audit_sweep`` -- the same audit over a stack of observation masks
                       (per aggregator, or the coalitions of Cor. D.2)
* ``dlg_attack``    -- DLG gradient inversion (Zhu et al. 2019) against a
                       masked observed gradient; ``dlg_attack_batch`` runs
                       it over a canary batch

The reference folds the rounds under ``lax.scan`` with every canary's
gradient of a round in a (C, n) matrix.  Here the canaries stream: a
round takes one canary's gradient at a time and keeps only its alignment
``d_c = <g_c, v (.) m>`` with the observed view, so at full width the
audit holds the view, the iterate and one gradient, never (C, n).  The
calibrated score ``(d_c - mean_c d_c) / (||v (.) m|| + 1e-12)`` is the
reference's ``(g - mean g) @ v / (||v|| + 1e-12)`` in exact arithmetic;
the two differ in the order of the sums only (the dot products and the
view's norm are accumulated in f64 here).

The statistics on the scores copy the reference's bits, as XLA's CPU
compiler computes them: a mean of a 0/1 array is the exact count times
the f32 reciprocal of its size, ``jnp.median`` of an even count the
f32 sum of the two middle values times 0.5, ``jnp.percentile`` linear
interpolation with the rank ``q * f32((n - 1) * f32(1/100))`` and the
product ``hi * w_hi`` fused into the sum (:func:`_percentile`), and the
bootstrap indices jax's threefry ``randint`` draws (``repro_torch.
random``), bit for bit.  So on the same scores the port's AUC, balanced
accuracy and both intervals equal the reference's.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import random, resolve_device
from repro_torch.core.compressors import reciprocal
from repro_torch.kernels.ref import fma_f32
from repro_torch.optim import adam


# ------------------------------------------------------- theoretical bounds
def mi_bound(n: int, T: int, p: float, A: int, c_max: float = 1.0,
             a_c: int = 1) -> float:
    """Mutual-information leakage bound (Thm 3.3 / Cor D.2):
    I(D_k; views) <= n * T * (p * A_c / A) * C_max."""
    return n * T * (p * a_c / A) * c_max


def gaussian_cmax(snr: float) -> float:
    """Per-coordinate MI under the Gaussian model of Remark D.1."""
    return 0.5 * math.log(1.0 + snr)


def observed_fraction(p: float, A: int, a_c: int = 1) -> float:
    """Expected fraction of update coordinates visible per round."""
    return p * a_c / A


# ----------------------------------------------------------------- MIA audit
def _dot(g: torch.Tensor, w: torch.Tensor) -> float:
    """<g, w> over flat vectors: each CHUNK's f32 dot added into an f64
    total on g's device (one read back at the end); a bf16 g is widened
    a window at a time, never whole."""
    total = torch.zeros((), dtype=torch.float64, device=g.device)
    n = g.numel()
    for lo in range(0, n, random.CHUNK):
        hi = min(n, lo + random.CHUNK)
        total += torch.dot(g[lo:hi].float(), w[lo:hi]).double()
    return float(total)


def _round_weights(v_t: torch.Tensor, obs: torch.Tensor):
    """(w, 1 / (||v (.) m|| + 1e-12)) of one round and mask: the reference
    scores ``(g (.) m - mean) @ (v (.) m)``, i.e. g against ``v (.) m (.)
    m``, which is ``v (.) m`` for a 0/1 mask."""
    u = v_t.float() * obs
    binary = bool(((obs == 0) | (obs == 1)).all())
    return (u if binary else u * obs), 1.0 / (_dot(u, u) ** 0.5 + 1e-12)


def _place(mesh: Optional[Sequence], C: int) -> list:
    """The device of each canary: the mesh's devices in equal contiguous
    groups (one device: all on it), or None without a mesh."""
    if mesh is None or len(mesh) <= 1:
        return [None] * C
    per = C // len(mesh)
    return [torch.device(mesh[c // per]) for c in range(C)]


def _mia_scores_multi(grad_fn: Callable, x_traj: torch.Tensor,
                      views: torch.Tensor, obs_masks: torch.Tensor,
                      all_c, mesh: Optional[Sequence] = None
                      ) -> torch.Tensor:
    """Per-mask, per-canary alignment scores (M, C) f32 on the host, for
    M masks with their view trajectories (M, T, n): each canary's
    gradient is taken once a round and scored against every mask."""
    M, C = obs_masks.shape[0], len(all_c)
    scores = np.zeros((M, C), dtype=np.float64)
    where = _place(mesh, C)
    for t in range(x_traj.shape[0]):
        x_t = x_traj[t]
        weights = [_round_weights(views[m, t], obs_masks[m])
                   for m in range(M)]
        copies: dict = {}
        d = np.zeros((M, C), dtype=np.float64)
        for c in range(C):
            dev = where[c]
            if dev is not None and dev != x_t.device:
                if dev not in copies:
                    copies[dev] = (x_t.to(dev),
                                   [w.to(dev) for w, _ in weights])
                x_c, ws = copies[dev]
                canary = all_c[c].to(dev)
            else:
                x_c, ws, canary = x_t, [w for w, _ in weights], all_c[c]
            g = grad_fn(x_c, canary)
            for m in range(M):
                d[m, c] = _dot(g, ws[m])
            del g
        del copies
        # calibration: the mean over all canaries is the only
        # cross-canary reduction
        inv = np.asarray([s for _, s in weights])[:, None]
        scores += (d - d.mean(1, keepdims=True)) * inv
    return torch.from_numpy(scores.astype(np.float32))


def _mia_scores(grad_fn: Callable, x_traj: torch.Tensor,
                views: torch.Tensor, obs_mask: torch.Tensor,
                all_c) -> torch.Tensor:
    """Per-canary alignment scores, summed over the rounds.

    For each canary c, score = sum_t <g~(x^t, c)|_obs, view^t|_obs> /
    ||view^t|_obs||, g~ the canary gradient calibrated by the mean over
    all canaries (the reference's docstring says why the view alone is
    normalized).  ``grad_fn(x (n,), canary) -> (n,)``; ``x_traj`` and
    ``views`` (T, n); ``all_c`` (C, ...).  Returns (C,) f32 on the
    host."""
    return _mia_scores_multi(grad_fn, x_traj, views[None], obs_mask[None],
                             all_c)[0]


def _mean_count(count: torch.Tensor, size: int) -> torch.Tensor:
    """The mean of a 0/1 array of ``size`` elements with ``count`` ones,
    as XLA computes ``jnp.mean``: the exact f32 count times the f32
    reciprocal of the size."""
    return count.float() * reciprocal(size)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` along the last axis (quantile 0.5, method
    'midpoint'): the f32 sum of the two middle values times 0.5."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    lo, hi = math.floor(0.5 * (n - 1)), math.ceil(0.5 * (n - 1))
    return (s[..., lo] + s[..., hi]) * 0.5


def _percentile(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``jnp.percentile(x, qs)`` along the last axis of an f32 tensor, as
    XLA's CPU compiler computes it: the rank ``q * f32(f32(n - 1) *
    f32(1/100))`` in f32 (the division by 100 folded into the constant),
    its floor and ceiling clamped to [0, n - 1], the weight ``w = rank -
    floor`` and the result ``fma(x[hi], w, x[lo] * (1 - w))``.  Returns
    (..., len(qs))."""
    s = torch.sort(x.float(), dim=-1).values
    n = x.shape[-1]
    c = np.float32(n - 1) * np.float32(reciprocal(100.0))
    out = []
    for q in qs:
        rank = np.float32(q) * c
        fl, ce = np.floor(rank), np.ceil(rank)
        lo, hi = int(min(max(fl, 0), n - 1)), int(min(max(ce, 0), n - 1))
        w = np.float32(rank - fl)
        lw = np.float32(np.float32(1.0) - w)
        out.append(fma_f32(float(w), s[..., hi], s[..., lo] * float(lw)))
    return torch.stack(out, dim=-1)


def _auc_balacc(s_in: torch.Tensor, s_out: torch.Tensor):
    """(AUC, balanced accuracy at the median threshold), f32, along the
    last axis (a leading batch axis is the bootstrap's)."""
    n_in, n_out = s_in.shape[-1], s_out.shape[-1]
    wins = (s_in[..., :, None] > s_out[..., None, :]).sum((-2, -1))
    auc = _mean_count(wins, n_in * n_out)
    thresh = _median(torch.cat([s_in, s_out], dim=-1))[..., None]
    bal = 0.5 * (_mean_count((s_in > thresh).sum(-1), n_in)
                 + _mean_count((s_out <= thresh).sum(-1), n_out))
    return auc, bal


def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a 1-D f32 tensor: XLA's CPU sum order times the f32
    reciprocal of the size."""
    return random.reduce_sum(x) * reciprocal(x.numel())


def _stats_from_scores(key: torch.Tensor, scores: torch.Tensor, n_in: int,
                       n_bootstrap: int) -> dict:
    """The reference's ``_mia_stats`` after the scores: AUC, balanced
    accuracy, the score gap and, with ``n_bootstrap``, the percentile
    bootstrap's 95% intervals (members and non-members resampled
    independently: ``split(key, n_bootstrap)``, then ``split(k)`` and a
    ``randint`` per class)."""
    s_in, s_out = scores[:n_in], scores[n_in:]
    n_out = s_out.numel()
    auc, bal = _auc_balacc(s_in, s_out)
    out = {"auc": auc, "balanced_accuracy": bal,
           "score_gap": _mean_f32(s_in) - _mean_f32(s_out)}
    if n_bootstrap:
        # jax's vmap over the keys: one batched draw per class
        pairs = random.split(random.split(key, n_bootstrap))   # (B, 2, 2)
        idx_in = random.randint(pairs[:, 0], (n_in,), 0, n_in)
        idx_out = random.randint(pairs[:, 1], (n_out,), 0, n_out)
        aucs, bals = _auc_balacc(s_in[idx_in], s_out[idx_out])
        out["auc_ci"] = _percentile(aucs, (2.5, 97.5))
        out["bal_acc_ci"] = _percentile(bals, (2.5, 97.5))
    return out


def _mia_stats(key: torch.Tensor, grad_fn: Callable, x_traj: torch.Tensor,
               views: torch.Tensor, obs_mask: torch.Tensor, canaries_in,
               canaries_out, n_bootstrap: int, mesh=None) -> dict:
    """Tensor-valued audit core (see :func:`mia_audit`)."""
    all_c = torch.cat([torch.as_tensor(canaries_in),
                       torch.as_tensor(canaries_out)], dim=0)
    scores = _mia_scores_multi(grad_fn, x_traj, views[None], obs_mask[None],
                               all_c, mesh)[0]
    return _stats_from_scores(key, scores, len(canaries_in), n_bootstrap)


def attack_mesh(n_canaries: int, devices: Optional[Sequence] = None
                ) -> tuple:
    """The devices the canary gradients are spread over: the longest
    prefix of ``devices`` (default: every CUDA card) whose length divides
    the canary count.  On one card it is that card: the unsharded
    audit."""
    if devices is None:
        resolve_device(None)            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    d = len(devices)
    while n_canaries % d:
        d -= 1
    return tuple(devices[:d])


def _host_stats(stats: dict) -> dict:
    out = {k: float(v) for k, v in stats.items() if v.dim() == 0}
    for k in ("auc_ci", "bal_acc_ci"):
        if k in stats:
            lo, hi = stats[k].tolist()
            out[k] = (float(lo), float(hi))
    return out


def mia_audit(key: torch.Tensor,
              grad_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              x_traj: torch.Tensor,        # (T, n) model iterates
              views: torch.Tensor,         # (T, n) adversary-observed update
              obs_mask: torch.Tensor,      # (n,) 0/1 observed coordinates
              canaries_in,                 # (C, ...) member canaries
              canaries_out,                # (C, ...) non-member canaries
              n_bootstrap: int = 200,
              mesh: Optional[Sequence] = None) -> dict:
    """Gradient-alignment membership inference (see :func:`_mia_scores`).

    Members (whose gradients entered the observed update) score higher.
    Returns the pairwise AUC, the balanced accuracy at the median
    threshold and the score gap, plus 95% bootstrap intervals ``auc_ci``
    and ``bal_acc_ci`` keyed on ``key`` (``n_bootstrap=0`` leaves them
    out).  ``mesh`` (an :func:`attack_mesh`) spreads the canaries over
    its devices in equal groups, each taking its gradients on a copy of
    the round's iterate and view; the calibration mean is the only
    cross-canary reduction, so the scores are the one-device audit's."""
    return _host_stats(_mia_stats(key, grad_fn, x_traj, views, obs_mask,
                                  canaries_in, canaries_out, n_bootstrap,
                                  mesh))


def mia_audit_sweep(key: torch.Tensor, grad_fn: Callable,
                    x_traj: torch.Tensor,      # (T, n)
                    views: torch.Tensor,       # (M, T, n) per-mask views
                    obs_masks: torch.Tensor,   # (M, n) mask stack
                    canaries_in, canaries_out,
                    n_bootstrap: int = 200) -> dict:
    """The audit over a stack of observation masks (every aggregator, or
    the coalitions a_c = 1..A of Cor. D.2) with their view trajectories,
    mask m keyed on ``split(key, M)[m]`` as the reference's vmap.  Each
    canary's gradient is taken once a round for all the masks.  Returns
    numpy arrays of shape (M,) (the intervals (M, 2))."""
    all_c = torch.cat([torch.as_tensor(canaries_in),
                       torch.as_tensor(canaries_out)], dim=0)
    scores = _mia_scores_multi(grad_fn, x_traj, views, obs_masks, all_c)
    per = [_stats_from_scores(k, scores[m], len(canaries_in), n_bootstrap)
           for m, k in enumerate(random.split(key, obs_masks.shape[0]))]
    return {name: torch.stack([p[name] for p in per]).numpy()
            for name in per[0]}


# ------------------------------------------------------------------ DLG/iDLG
def dlg_attack(key: torch.Tensor,
               grad_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                 torch.Tensor],
               x: torch.Tensor,             # model at attack round (n,)
               g_obs: torch.Tensor,         # observed (masked) gradient (n,)
               obs_mask: torch.Tensor,      # (n,) 0/1
               input_shape: tuple,
               label,                       # iDLG: label assumed recovered
               steps: int = 300, lr: float = 0.1) -> dict:
    """Reconstruct the input from an observed (possibly FSA/DSC-masked,
    possibly int8-wire round-tripped) per-sample gradient by gradient
    matching on the observed coordinates: ``steps`` Adam steps on the
    match loss.  ``grad_fn(x, dummy, label)`` must return the parameter
    gradient with its graph (``create_graph=True``), since the match
    loss is differentiated through it.  Returns the reconstruction and
    the (steps,) match losses, each taken before its step."""
    dummy = 0.1 * random.normal(key, input_shape, device=x.device)
    target = g_obs * obs_mask
    opt = adam(lr)
    state = opt.init(dummy)
    losses = []
    for _ in range(steps):
        d = dummy.detach().requires_grad_()
        with torch.enable_grad():
            g = grad_fn(x, d, label) * obs_mask
            loss = torch.sum((g - target) ** 2)
            grad = torch.autograd.grad(loss, d)[0]
        losses.append(loss.detach())
        delta, state = opt.update(grad, state, dummy)
        dummy = dummy + delta
    return {"reconstruction": dummy, "match_losses": torch.stack(losses)}


def dlg_attack_batch(key: torch.Tensor, grad_fn: Callable, x: torch.Tensor,
                     g_obs: torch.Tensor,      # (C, n) observed gradients
                     obs_mask: torch.Tensor, input_shape: tuple,
                     labels: torch.Tensor,     # (C,) recovered labels
                     steps: int = 300, lr: float = 0.1) -> dict:
    """DLG over a canary batch: C independent inversions (a shared model
    point and mask), canary c keyed on ``split(key, C)[c]``."""
    outs = [dlg_attack(k, grad_fn, x, g, obs_mask, input_shape, lab,
                       steps, lr)
            for k, g, lab in zip(random.split(key, g_obs.shape[0]), g_obs,
                                 labels)]
    return {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


def reconstruction_mse(recon: torch.Tensor, target: torch.Tensor) -> float:
    """Scale-invariant reconstruction error (lower = better attack)."""
    recon, target = recon.float(), target.float()
    r = (recon - recon.mean()) / (recon.std(correction=0) + 1e-8)
    t = (target - target.mean()) / (target.std(correction=0) + 1e-8)
    return float(torch.mean((r - t) ** 2))
