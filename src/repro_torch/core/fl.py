"""Federated engine (``repro/core/fl.py``): runs ERIS or any baseline of
the method registry over a model and per-client data.

The model's parameter tree is flattened once (``convert.ravel_params``,
in ``ravel_pytree`` order) so every stage works on the paper's R^n
update vectors.  ``FLRun.step`` runs one round of the method's
:class:`~repro_torch.core.pipeline.RoundPipeline`; ``run_scanned`` and
``run_fl_scan``, one fused XLA program in the reference, are a loop over
``step`` here and give the same trajectory.

Keys.  As the reference, ``FLRun`` holds ``PRNGKey(cfg.seed)`` and
splits it every round into the round's role keys (``repro_torch.random``,
jax's threefry stream bit for bit), and ``run_fl`` and ``run_fl_scan``
key round t's batches from ``PRNGKey(cfg.seed + 1)``: the same seed
gives the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.convert import ravel_params, tree_leaves, tree_unflatten
from repro_torch.core import rounds as rounds_lib
from repro_torch.core.compressors import Compressor, Identity
from repro_torch.core.pipeline import (RoundKeys, RoundState, client_batch,
                                       participation_weights,
                                       split_round_keys)
from repro_torch.core.settings import AsyncSettings, resolve_async


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's FLConfig, field for field with the same defaults.
    With ``population`` > 0 (fedbuff, eris_async) a round's batches
    carry the whole population on their leading axis and K is the
    cohort drawn from it."""
    method: str = "eris"          # any key of rounds.METHODS
    K: int = 8                    # clients
    A: int = 4                    # aggregators (eris)
    rounds: int = 50
    lr: float = 0.1
    use_dsc: bool = False
    use_ef: bool = False          # error feedback (biased compressors)
    compressor: Compressor = Identity()
    server_opt: str = "fedavg"    # fedavg|fedadam|fedyogi (Sec. 5 Benefits)
    participation: float = 1.0    # client sampling fraction per round
    gamma: Optional[float] = None
    mask_scheme: str = "strided"
    fresh_masks: bool = False     # re-draw random masks per round (m^t)
    ldp: Optional[Any] = None
    secure_mask: bool = False
    prune_rate: float = 0.1       # priprune
    shatter_chunks: int = 8
    shatter_r: int = 4
    agg_dropout: float = 0.0      # appendix F.5 failure injection
    link_failure: float = 0.0
    compress_impl: str = "jnp"    # jnp | pallas (kernels/dsc_update) | fused
                                  # (one-pass kernels/dsc_quantize, int8+DSC)
    int8_wire: bool = False       # int8 wire quantization stage
    keep_views: bool = False      # materialize (A, K, n) aggregator views
    population: int = 0
    buffer_cadence: int = 1
    staleness_alpha: float = 1.0
    delay_max: int = 0
    client_dropout: float = 0.0
    async_: Optional[AsyncSettings] = None
    seed: int = 0

    def async_settings(self) -> AsyncSettings:
        """The resolved async-runtime knobs (``core/settings.py``)."""
        return resolve_async("FLConfig", self.async_, self)


class FLRun:
    """The round pipeline and the training state it carries.

    ``params0`` is a tree of tensors (nested dicts, as the model's);
    ``loss_fn(params, batch)`` returns a scalar tensor.  The state lives
    on ``device``: the CUDA card unless the caller asks for the CPU.
    ``key`` is the run's key (on the host), ``keys`` the last round's
    role keys."""

    def __init__(self, cfg: FLConfig, params0: Any,
                 loss_fn: Callable[[Any, Any], torch.Tensor],
                 device: DeviceLike = None):
        self.cfg = cfg
        self.key = random.PRNGKey(cfg.seed)
        self.keys: Optional[RoundKeys] = None
        self.device = resolve_device(device)
        flat0, self.unravel = ravel_params(params0)
        flat0 = flat0.to(self.device)
        self.n = flat0.numel()
        self.loss_fn = loss_fn
        self.pipeline = rounds_lib.build_round(cfg, self.n)
        self.state: RoundState = self.pipeline.init_state(flat0, cfg.K)
        self.t = 0
        # each client's loss at the shared x, one list per round
        self.client_losses: List[List[torch.Tensor]] = []

    # -------------------------------------------------- state conveniences
    @property
    def x(self) -> torch.Tensor:
        return self.state.x

    # ---------------------------------------------------------------- core
    def _grad(self, x: torch.Tensor, batch) -> torch.Tensor:
        """d loss(unravel(x)) / dx for one client, flat in x's dtype: the
        leaves' gradients (in their own dtypes) cast into one vector, as
        the reference's grad through unravel's casts gives it."""
        tree = self.unravel(x)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
        with torch.enable_grad():
            loss = self.loss_fn(tree_unflatten(tree, leaves), batch)
            grads = list(torch.autograd.grad(loss, leaves))
        self.client_losses[-1].append(loss.detach())
        del tree, leaves, loss
        # each leaf's gradient is dropped as soon as it is in the flat
        # vector: at full width the bf16 gradients and the f32 vector
        # would otherwise coexist (3.6 + 7.3 GB)
        flat = torch.empty(self.n, dtype=x.dtype, device=x.device)
        offset = 0
        for i, g in enumerate(grads):
            grads[i] = None
            flat[offset:offset + g.numel()].copy_(g.reshape(-1))
            offset += g.numel()
            del g
        return flat

    # ----------------------------------------------------------------- API
    def step(self, batches, collect_views: bool = False):
        """One round on ``batches`` (a pytree with a leading K axis, or
        population axis under a cohort draw), with the next split of the
        run's key, as the reference's ``step``."""
        self.key, sub = random.split(self.key)
        self.keys = split_round_keys(sub)
        weights = participation_weights(self.keys.part, self.cfg.K,
                                        self.cfg.participation)
        self.t += 1
        self.client_losses.append([])
        self.state, views = self.pipeline.run_round(
            self._grad, self.keys, self.state, batches, self.cfg.K,
            weights=weights, collect_views=collect_views)
        return views if collect_views else None

    def run_scanned(self, batches_stacked, collect_views: bool = False):
        """T rounds (T = leading dim of ``batches_stacked``), stepping in
        order; returns the model iterates (T, n), as the reference's
        scan-compiled driver does.  With ``collect_views`` also the
        rounds' adversary views stacked on a leading T axis (``(T, A, K,
        n)`` under ``FLConfig.keep_views``): the privacy audit's
        capture."""
        T = len(tree_leaves(batches_stacked)[0])
        xs, views = [], []
        for t in range(T):
            v = self.step(client_batch(batches_stacked, t),
                          collect_views=collect_views)
            if collect_views:
                if v is None:
                    raise ValueError(
                        "collect_views: this pipeline exposes no adversary "
                        "view (view='none' and no aggregate override)")
                views.append(v)
            xs.append(self.x.clone())
        if collect_views:
            return torch.stack(xs), torch.stack(views)
        return torch.stack(xs)

    def params(self):
        return self.unravel(self.x)

    @torch.no_grad()
    def evaluate(self, batch) -> float:
        return float(self.loss_fn(self.params(), batch))


def _data_keys(cfg: FLConfig) -> List[torch.Tensor]:
    """Round t's data key: the t-th split of ``PRNGKey(cfg.seed + 1)``."""
    key, subs = random.PRNGKey(cfg.seed + 1), []
    for _ in range(cfg.rounds):
        key, sub = random.split(key)
        subs.append(sub)
    return subs


def run_fl(cfg: FLConfig, params0, loss_fn, batches_per_round,
           eval_batch=None, eval_every: int = 10, device: DeviceLike = None):
    """Convenience runner.  ``batches_per_round(t, key)`` returns round
    t's per-client batches (leading K)."""
    run = FLRun(cfg, params0, loss_fn, device=device)
    losses = []
    for t, key in enumerate(_data_keys(cfg)):
        run.step(batches_per_round(t, key))
        if eval_batch is not None and (t % eval_every == 0
                                       or t == cfg.rounds - 1):
            losses.append((t, run.evaluate(eval_batch)))
    return run, losses


def run_fl_scan(cfg: FLConfig, params0, loss_fn, batches_per_round,
                eval_batch=None, eval_every: int = 10,
                device: DeviceLike = None):
    """The reference's scan-compiled twin of :func:`run_fl`: batches made
    up front, the rounds run, the recorded iterates evaluated after.  The
    trajectory is :func:`run_fl`'s."""
    run = FLRun(cfg, params0, loss_fn, device=device)
    per_round = [batches_per_round(t, key)
                 for t, key in enumerate(_data_keys(cfg))]
    xs = []
    for batches in per_round:
        run.step(batches)
        xs.append(run.x)
    losses = []
    if eval_batch is not None:
        with torch.no_grad():
            for t in range(cfg.rounds):
                if t % eval_every == 0 or t == cfg.rounds - 1:
                    losses.append((t, float(loss_fn(run.unravel(xs[t]),
                                                    eval_batch))))
    return run, losses
