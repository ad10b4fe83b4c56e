"""ERIS round engine (``repro/core/eris.py``): Algorithm 1 (FSA with
optional DSC) as a function over an :class:`ErisState`.

The reference jits ``round_step`` and ``jax.lax.scan``s it in ``run``;
here ``run`` is a loop over :func:`round_step`, which drives the same
stage objects the simulator's registry composes (``core/pipeline.py``),
one client at a time.  It keeps this engine's own key discipline: each
round splits its key into the next key, a ``mask`` key and a ``comp``
key, and the noise, fail and part roles alias ``comp`` unless a stage of
the round consumes them, when they are ``fold_in(comp, ROLE_SALTS[role])``
(:func:`_round_keys`).  ``grad_fn(x, client_batch) -> (n,)`` gives one
client's flat gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import random
from repro_torch.core import baselines as bl
from repro_torch.core import dsc as dsc_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core import pipeline as pl
from repro_torch.core.compressors import Compressor, Identity


class ErisState(NamedTuple):
    x: torch.Tensor            # global model (n,)
    dsc: dsc_lib.DSCState      # reference vectors (zeros when DSC disabled)
    t: int                     # round counter
    key: torch.Tensor
    buf: Any = None            # pl.BufferState under async buffering


@dataclasses.dataclass(frozen=True)
class ErisConfig:
    A: int = 4                      # number of client-side aggregators
    lr: float = 0.1
    compressor: Compressor = Identity()
    gamma: Optional[float] = None   # None -> gamma*(omega) of Thm 3.2
    mask_scheme: str = "strided"
    fresh_masks: bool = False       # re-draw random masks each round (m^t)
    use_dsc: bool = False
    # ---- FedBuff-style buffered async aggregation (pl.BufferedAggregate)
    async_buffer: bool = False
    buffer_cadence: int = 1
    staleness_alpha: float = 1.0
    delay_max: int = 0
    client_dropout: float = 0.0
    # ---- composed-defense / failure scenario axes (rounds.scenarios)
    ldp: Optional[bl.LDPConfig] = None   # clip + Gaussian noise pre-wire
    secure_mask: bool = False            # Bonawitz pairwise wire masking
    agg_dropout: float = 0.0             # aggregator dropout probability
    link_failure: float = 0.0            # client->aggregator link failure
    participation: float = 1.0           # Bernoulli client sampling

    def gamma_value(self, n: int) -> float:
        if self.gamma is not None:
            return self.gamma
        if not self.use_dsc:
            return 0.0
        return dsc_lib.gamma_star(self.compressor.omega(n))


def init(key: torch.Tensor, x0: torch.Tensor, K: int,
         async_buffer: bool = False) -> ErisState:
    n = x0.shape[0]
    return ErisState(x0, dsc_lib.init_state(K, n, device=x0.device), 0, key,
                     pl.init_buffer(n, x0.device) if async_buffer else None)


# Role salts for the composed-scenario paths: when a stage that consumes
# the noise/fail/part role is in the stage list, that role's key is
# fold_in(k_comp, salt) instead of aliasing k_comp, so LDP noise, failure
# draws and participation are not correlated with the compression's
# randomness; roles with no consumer keep the alias.
ROLE_SALTS = {"noise": 0x4E0E, "fail": 0xFA11, "part": 0x9A87}


def stage_roles(compress: tuple, aggregate: pl.AggregateStage
                ) -> frozenset[str]:
    """Key roles consumed by an eris stage list.  BufferedAggregate with
    the trivial arrival model draws nothing and is left out (the
    degenerate async == sync parity stays bit for bit)."""
    roles = {st.key_role for st in compress}
    agg = aggregate
    while isinstance(agg, pl.BufferedAggregate):
        if not agg.arrival.trivial:
            roles.add(agg.key_role)
        agg = agg.inner
    roles.add(agg.key_role)
    return frozenset(roles)


def _round_keys(k_mask: torch.Tensor, k_comp: torch.Tensor,
                active: frozenset = frozenset()) -> pl.RoundKeys:
    """RoundKeys with this engine's two-key discipline (mask + comp);
    roles in ``active`` get their salted key (see ROLE_SALTS)."""
    c0, c1 = random.split(k_comp)

    def role(r: str) -> torch.Tensor:
        if r in active:
            return random.fold_in(k_comp, ROLE_SALTS[r])
        return k_comp

    return pl.RoundKeys(mask=k_mask, comp=k_comp, noise=role("noise"),
                        fail=role("fail"), part=role("part"),
                        comp0=c0, comp1=c1,
                        wire=random.fold_in(k_comp, 0x3177))


def stages(cfg: ErisConfig, n: int, keep_views: bool = False
           ) -> tuple[tuple, pl.AggregateStage]:
    """The stage list this engine executes: the same stage objects the
    simulator's registry composes.  The fresh-mask (m^t) path aggregates
    through :class:`pl.FSASharded` with a keyed per-round assignment; the
    static-mask path uses the algebraic mean (Theorem B.1)."""
    gamma = cfg.gamma_value(n)
    failures = cfg.agg_dropout > 0.0 or cfg.link_failure > 0.0
    if cfg.secure_mask and (failures or cfg.participation < 1.0
                            or cfg.client_dropout > 0.0):
        raise ValueError(
            "secure_mask cannot compose with failures/dropout/partial "
            "participation: pairwise masks cancel only in the unweighted "
            "full-cohort mean and this simplified Bonawitz protocol has "
            "no dropout-recovery round (Sec. 2) — the aggregate would be "
            "garbage of magnitude `scale`, so refuse loudly")
    compress: tuple = ()
    if cfg.ldp is not None:
        compress += (pl.LDPNoise(ldp=cfg.ldp),)
    if cfg.use_dsc:
        compress += (pl.DSCCompress(compressor=cfg.compressor, gamma=gamma),)
    if cfg.secure_mask:
        compress += (pl.PairwiseMask(),)
    if failures:
        aggregate: pl.AggregateStage = pl.FailureInjectedFSA(
            A=cfg.A, mask_scheme=cfg.mask_scheme,
            agg_dropout=cfg.agg_dropout, link_failure=cfg.link_failure,
            use_dsc=cfg.use_dsc, gamma=gamma, keep_views=keep_views)
    elif cfg.fresh_masks or keep_views:
        aggregate = pl.FSASharded(
            A=cfg.A, mask_scheme=cfg.mask_scheme,
            fresh_masks=cfg.fresh_masks, use_dsc=cfg.use_dsc, gamma=gamma,
            keep_views=keep_views)
    elif cfg.use_dsc:
        aggregate = pl.DSCAggregate(gamma=gamma)
    else:
        aggregate = pl.AggregateStage()
    if cfg.async_buffer:
        if cfg.use_dsc:
            raise ValueError(
                "async_buffer does not compose with use_dsc: the Eq. 4 "
                "shift state tracks per-round aggregator receipts, which "
                "a cadence-delayed buffered apply breaks")
        aggregate = pl.BufferedAggregate(
            inner=aggregate, cadence=cfg.buffer_cadence,
            arrival=pl.ArrivalModel(delay_max=cfg.delay_max,
                                    dropout=cfg.client_dropout,
                                    alpha=cfg.staleness_alpha))
    return compress, aggregate


def round_step(state: ErisState, cfg: ErisConfig,
               grad_fn: Callable[[torch.Tensor, Any], torch.Tensor],
               client_batches, weights: Optional[torch.Tensor] = None,
               keep_views: bool = False):
    """One ERIS round.  Returns (new_state, aux): aux holds the
    assignment and, with ``keep_views``, the transmitted (K, n) vectors
    and the aggregators' shard views (the reference returns the
    transmitted vectors every round; streamed, they are kept only when
    asked for).  The shift state is updated in place."""
    n = state.x.shape[0]
    key, k_mask, k_comp = random.split(state.key, 3)
    compress, aggregate = stages(cfg, n, keep_views)
    active = stage_roles(compress, aggregate)
    sample = cfg.participation < 1.0 and weights is None
    if sample:
        active = active | {"part"}
    keys = _round_keys(k_mask, k_comp, active & set(ROLE_SALTS))
    K = state.dsc.s_clients.shape[0]
    if sample:
        weights = pl.participation_weights(keys.part, K, cfg.participation)

    rstate = pl.RoundState(x=state.x, dsc=state.dsc, server=None, ef=None,
                           buf=state.buf)
    pipe = pl.RoundPipeline(compress=compress, aggregate=aggregate)
    agg, transmitted = pipe.aggregate_round(
        grad_fn, keys, rstate, client_batches, K, weights,
        collect_views=keep_views, keep_transmitted=keep_views)
    x_new = state.x - cfg.lr * agg.update

    mask_stage = (aggregate.inner
                  if isinstance(aggregate, pl.BufferedAggregate)
                  else aggregate)
    assign = (mask_stage.assignment(keys, n, state.x.device)
              if isinstance(mask_stage, pl.FSASharded)
              else masks_lib.make_assignment(n, cfg.A, cfg.mask_scheme,
                                             device=state.x.device))
    new_state = ErisState(x_new, agg.state.dsc, state.t + 1, key,
                          agg.state.buf)
    aux = {"assign": assign, "transmitted": transmitted,
           "shard_views": agg.views}
    return new_state, aux


def run(key: torch.Tensor, x0: torch.Tensor, cfg: ErisConfig, grad_fn,
        client_batches_per_round, T: int, weights=None):
    """T rounds with static per-round client batches (leading dims (T, K,
    ...)).  Returns (final state, the iterates (T, n))."""
    state = init(key, x0, client_batches_per_round.shape[1],
                 async_buffer=cfg.async_buffer)
    xs = []
    for t in range(T):
        state, _ = round_step(state, cfg, grad_fn,
                              client_batches_per_round[t], weights)
        xs.append(state.x)
    return state, torch.stack(xs)
