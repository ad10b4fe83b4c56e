"""Federated engine (``repro/core/fl.py``): runs ERIS or FedAvg over a
model and per-client data.

The model's parameter tree is flattened once (``convert.ravel_params``,
in ``ravel_pytree`` order) so every stage works on the paper's R^n
update vectors.  ``FLRun.step`` runs one round of the method's
:class:`~repro_torch.core.pipeline.RoundPipeline`; ``run_scanned`` and
``run_fl_scan``, one fused XLA program in the reference, are a loop over
``step`` here and give the same trajectory.

Seeds.  The reference splits a threefry key every round; the port draws
each round's kernel seeds from a counter-based stream keyed on
(``FLConfig.seed``, round, role) through ``kernels/common.hash_u32``
(:func:`round_seeds`).  ``step`` also takes the seeds explicitly, which
is how the tests replay the reference's own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.convert import ravel_params, tree_leaves, tree_unflatten
from repro_torch.core import rounds as rounds_lib
from repro_torch.core.compressors import Compressor, Identity
from repro_torch.core.pipeline import RoundSeeds, RoundState, client_batch
from repro_torch.kernels.common import hash_u32


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """The reference's FLConfig, field for field with the same defaults.
    The port runs the synchronous fedavg and eris rounds; ``ldp`` and the
    async knobs belong to methods it does not run yet (ROADMAP queue 1.7)
    and ``participation < 1`` draws from jax.random (queue 1.2)."""
    method: str = "eris"          # fedavg | eris (rounds.METHODS)
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
    async_: Optional[Any] = None
    seed: int = 0


_ROLES = len(RoundSeeds._fields)


def round_seeds(seed: int, t: int) -> RoundSeeds:
    """Round t's kernel seeds, one per role: murmur3 keyed on (seed,
    round, role).  Not the reference's threefry stream (ROADMAP queue
    1.2), so a trajectory equals the reference's only when the caller
    hands ``step`` the reference's seeds."""
    key = hash_u32(torch.tensor([seed]) ^ hash_u32(torch.tensor([t])))
    bits = hash_u32(key ^ hash_u32(torch.arange(1, _ROLES + 1)))
    return RoundSeeds(*(int(b) for b in bits))


class FLRun:
    """The round pipeline and the training state it carries.

    ``params0`` is a tree of tensors (nested dicts, as the model's);
    ``loss_fn(params, batch)`` returns a scalar tensor.  The state lives
    on ``device``: the CUDA card unless the caller asks for the CPU."""

    def __init__(self, cfg: FLConfig, params0: Any,
                 loss_fn: Callable[[Any, Any], torch.Tensor],
                 device: DeviceLike = None):
        if cfg.participation < 1.0:
            raise NotImplementedError(
                "participation < 1 draws its clients from jax.random; the "
                "port has no threefry key stream yet (ROADMAP queue 1.2)")
        self.cfg = cfg
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
    def step(self, batches, collect_views: bool = False,
             seeds: Optional[RoundSeeds] = None):
        """One round on ``batches`` (a pytree with a leading K axis).
        ``seeds`` defaults to :func:`round_seeds` of this round."""
        if seeds is None:
            seeds = round_seeds(self.cfg.seed, self.t)
        self.t += 1
        self.client_losses.append([])
        self.state, views = self.pipeline.run_round(
            self._grad, seeds, self.state, batches, self.cfg.K,
            collect_views=collect_views)
        return views if collect_views else None

    def run_scanned(self, batches_stacked) -> torch.Tensor:
        """T rounds (T = leading dim of ``batches_stacked``), stepping in
        order; returns the model iterates (T, n), as the reference's
        scan-compiled driver does."""
        T = len(tree_leaves(batches_stacked)[0])
        xs = []
        for t in range(T):
            self.step(client_batch(batches_stacked, t))
            xs.append(self.x.clone())
        return torch.stack(xs)

    def params(self):
        return self.unravel(self.x)

    @torch.no_grad()
    def evaluate(self, batch) -> float:
        return float(self.loss_fn(self.params(), batch))


def _data_seed(cfg: FLConfig, t: int) -> int:
    return round_seeds(cfg.seed + 1, t).comp


def run_fl(cfg: FLConfig, params0, loss_fn, batches_per_round,
           eval_batch=None, eval_every: int = 10, device: DeviceLike = None):
    """Convenience driver.  ``batches_per_round(t, data_seed)`` returns
    round t's per-client batches (leading K)."""
    run = FLRun(cfg, params0, loss_fn, device=device)
    losses = []
    for t in range(cfg.rounds):
        run.step(batches_per_round(t, _data_seed(cfg, t)))
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
    per_round = [batches_per_round(t, _data_seed(cfg, t))
                 for t in range(cfg.rounds)]
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
