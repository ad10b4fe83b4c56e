"""The FL round as a stage graph (``repro/core/pipeline.py``, the paper's
Algorithm 1), synchronous stages only:

    ClientStep      local gradients                       (Alg. 1 line 3)
    CompressStage*  what leaves the client                (line 4: DSC on
                    the wire kernels, the int8 wire)
    AggregateStage  how shards meet                       (lines 5-13)
    ServerStage     how the global model moves            (line 14)

The reference vmaps the K clients into (K, n) arrays.  Here a round
streams them: for client k it takes the gradient at the shared x, runs it
through the compress stages (which update client k's row of the shift
state in place) and hands the transmitted vector to the aggregate stage,
which folds it into one f32 accumulator.  The values are the reference's;
the memory is one client's vectors at a time, so a round of
eris-gptneo-1.3b (n = 1.8e9) fits one 80 GB card.  Only what the
configuration uses is allocated: no shift state without DSC, no
error-feedback state at all.

Randomness.  The reference derives every kernel seed from threefry role
keys (``split_round_keys``, ``_seed_of``); the port takes them as a
:class:`RoundSeeds` of uint32 values.  ``core/fl.FLRun`` draws its own
from a counter-based stream, and a test can hand in the reference's.

The draws' global index.  A reference kernel call sees the flattened,
padded (K, n_pad) block, so client k's coordinate i draws from index
k * n_pad + i (mod 2**32).  n_pad rounds n up to 1024 for ``dsc_update``
(``LANES``) and to 256 for ``dsc_quantize`` and ``Int8Wire`` (``QBLOCK``);
each stage passes its own ``index_base``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, NamedTuple, Optional

import torch

from repro_torch.core import dsc as dsc_lib
from repro_torch.core import fsa as fsa_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core import server_opt as so_lib
from repro_torch.core.compressors import (Compressor, Identity,
                                          Int8RoundTrip, RandP)
from repro_torch.kernels import dsc_quantize as dq_kernel
from repro_torch.kernels import dsc_update as du_kernel
from repro_torch.kernels import quantize as q_kernel


# ================================================================== state
class RoundState(NamedTuple):
    """Everything a round carries forward."""
    x: torch.Tensor                      # global model (n,)
    dsc: Optional[dsc_lib.DSCState]      # None unless a stage uses DSC
    server: Any                          # server optimizer state


class RoundSeeds(NamedTuple):
    """One round's kernel seeds (uint32), by the reference's role keys:
    ``comp`` is ``_seed_of(keys.comp)`` (the ``pallas`` DSC kernel);
    ``comp_mask`` and ``comp_round`` are the seeds of
    ``split(keys.comp)`` (the fused kernel's mask and rounding draws);
    ``wire`` is ``_seed_of(keys.wire)`` (the int8 wire stage)."""
    comp: int
    comp_mask: int
    comp_round: int
    wire: int


def client_batch(batches, k: int):
    """Client k's slice of a pytree of per-client batches (leading K)."""
    if isinstance(batches, dict):
        return {name: client_batch(b, k) for name, b in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(client_batch(b, k) for b in batches)
    return batches[k]


# ================================================================= client
@dataclasses.dataclass(frozen=True)
class ClientStep:
    """Local update: one full-batch gradient per client (Algorithm 1
    line 3), one client at a time.  ``grad_fn(x, batch)`` returns the
    flat gradient in x's dtype."""

    def __call__(self, grad_fn: Callable, x: torch.Tensor, batches, K: int
                 ) -> Iterator[torch.Tensor]:
        for k in range(K):
            yield grad_fn(x, client_batch(batches, k))


# ============================================================== compress
@dataclasses.dataclass(frozen=True)
class CompressStage:
    """Base stage: identity (what FedAvg transmits).  ``apply`` maps
    client k's vector to what it transmits, updating the state in
    place."""

    def apply(self, seeds: RoundSeeds, state: RoundState, v: torch.Tensor,
              k: int) -> torch.Tensor:
        return v


@dataclasses.dataclass(frozen=True)
class DSCCompress(CompressStage):
    """Distributed shifted compression, client side (Sec. 3.2.2):
    v_k = C(g_k - s_k);  s_k <- s_k + gamma v_k, s_k updated in place.

    ``impl='pallas'`` runs a RandP compressor through the ``dsc_update``
    kernel; ``impl='fused'`` runs ``Int8RoundTrip(RandP)`` (or RandP)
    through the one-pass ``dsc_quantize`` kernel and transmits the
    dequantized wire value, which the shift tracks.  ``impl='jnp'``
    composes the dense compressor, whose draws come from ``jax.random``:
    it waits for the port's key stream (ROADMAP queue 1.2)."""

    compressor: Compressor = Identity()
    gamma: float = 0.0
    impl: str = "jnp"            # pallas | fused  (jnp: queue 1.2)

    def __post_init__(self):
        if self.impl == "jnp":
            raise NotImplementedError(
                "DSCCompress(impl='jnp') draws the compressor's mask from "
                "jax.random; the port has no threefry key stream yet "
                "(ROADMAP queue 1.2): use impl='pallas' or 'fused'")
        if self.impl not in ("pallas", "fused"):
            raise ValueError(f"unknown DSC impl {self.impl!r}")
        inner = self.compressor
        if self.impl == "fused" and isinstance(inner, Int8RoundTrip):
            inner = inner.inner
        if not isinstance(inner, RandP):
            raise ValueError(f"{self.impl} DSC path needs a RandP (fused: "
                             f"or Int8RoundTrip(RandP)) compressor, got "
                             f"{self.compressor.name!r}")

    @property
    def p(self) -> float:
        comp = self.compressor
        return (comp.inner if isinstance(comp, Int8RoundTrip) else comp).p

    def apply(self, seeds, state, g, k):
        s = state.dsc.s_clients[k]
        n = g.numel()
        if self.impl == "pallas":
            v, _ = du_kernel.dsc_update(
                g, s, seeds.comp, p=self.p, gamma=self.gamma,
                index_base=k * q_kernel.padded(n, du_kernel.LANES), out=s)
            return v
        q, scales, _ = dq_kernel.dsc_quantize(
            g, s, seeds.comp_mask, seeds.comp_round, p=self.p,
            gamma=self.gamma,
            index_base=k * q_kernel.padded(n), out=s)
        # the simulator aggregates in f32, so reconstruct the wire value
        return q_kernel.dequantize(q, scales)[:n]


@dataclasses.dataclass(frozen=True)
class Int8Wire(CompressStage):
    """Beyond-paper wire format: per-256-block stochastic int8
    quantize -> dequantize round trip on the ``quantize`` kernels."""

    def apply(self, seeds, state, v, k):
        n = v.numel()
        q, scales = q_kernel.quantize(
            v, seeds.wire, index_base=k * q_kernel.padded(n))
        return q_kernel.dequantize(q, scales)[:n]


# ============================================================== aggregate
class AggregateResult(NamedTuple):
    update: torch.Tensor                  # aggregated pseudo-gradient (n,)
    state: RoundState
    views: Optional[torch.Tensor] = None  # adversary-view override


@dataclasses.dataclass(frozen=True)
class AggregateStage:
    """Base: exact mean, FedAvg's all-reduce and equally FSA's algebraic
    form (Theorem B.1).  ``vs`` yields the K transmitted vectors one at
    a time.  The reference's per-client weights come from client
    sampling, which waits for the key stream (ROADMAP queue 1.2): every
    client weighs 1/K."""

    def apply(self, seeds: RoundSeeds, state: RoundState,
              vs: Iterator[torch.Tensor], K: int) -> AggregateResult:
        return AggregateResult(fsa_lib.weighted_sum(vs, K=K), state)


@dataclasses.dataclass(frozen=True)
class DSCAggregate(AggregateStage):
    """Aggregator-side shift compensation (Eq. 4):
    u = s_agg + mean_k v_k;  s_agg <- s_agg + gamma mean_k v_k."""

    gamma: float = 0.0

    def apply(self, seeds, state, vs, K):
        u, _ = dsc_lib.aggregate(state.dsc, vs, self.gamma, K=K)
        return AggregateResult(u, state)


@dataclasses.dataclass(frozen=True)
class FSASharded(AggregateStage):
    """Literal Algorithm 1 lines 5-13: per-aggregator masked shards,
    aggregated independently and reassembled; iterate-identical to the
    mean (Theorem B.1), and it exposes the aggregators' views.  It holds
    all K vectors (and, with ``keep_views``, the (A, K, n) views), so it
    is for simulator sizes.  ``fresh_masks`` redraws the assignment each
    round from ``jax.random``: that waits for the key stream (ROADMAP
    queue 1.2)."""

    A: int = 4
    mask_scheme: str = "strided"
    keep_views: bool = True
    fresh_masks: bool = False
    use_dsc: bool = False
    gamma: float = 0.0

    def __post_init__(self):
        if self.fresh_masks:
            raise NotImplementedError(
                "FSASharded(fresh_masks=True) draws its masks from "
                "jax.random; the port has no threefry key stream yet "
                "(ROADMAP queue 1.2)")

    def apply(self, seeds, state, vs, K):
        v = torch.stack(list(vs))
        n = v.shape[1]
        assign = masks_lib.make_assignment(n, self.A, self.mask_scheme,
                                           device=v.device)
        out = fsa_lib.fsa_round_sharded(
            torch.zeros(n, device=v.device), v, assign, self.A, 1.0,
            keep_views=self.keep_views)
        mean_v = -out.x_new
        if self.use_dsc:
            s_agg = state.dsc.s_agg
            u = s_agg + mean_v
            s_agg.add_(mean_v, alpha=self.gamma)
        else:
            u = mean_v
        return AggregateResult(u, state, out.shard_views)


# ================================================================= server
@dataclasses.dataclass(frozen=True)
class ServerStage:
    """Global model update from the aggregated pseudo-gradient."""

    opt: str = "fedavg"          # fedavg | fedadam | fedyogi
    lr: float = 0.1

    def make(self) -> so_lib.ServerOpt:
        return so_lib.get_server_opt(self.opt, self.lr)

    def init(self, x0: torch.Tensor):
        return self.make().init(x0)

    def apply(self, state: RoundState, u: torch.Tensor) -> RoundState:
        delta, sstate = self.make().update(u, state.server)
        # a bf16 x plus an f32 delta is f32 from here on, as in the
        # reference (ravel_pytree of bf16 params gives a bf16 x)
        return state._replace(x=state.x + delta, server=sstate)


# =============================================================== pipeline
@dataclasses.dataclass(frozen=True)
class RoundPipeline:
    """One FL method: client -> compress* -> aggregate -> server.
    ``view`` names what an adversary observes: the transmitted per-client
    vectors, an aggregate-stage override, or nothing."""

    client: ClientStep = ClientStep()
    compress: tuple = ()
    aggregate: AggregateStage = AggregateStage()
    server: ServerStage = ServerStage()
    view: str = "none"           # none | transmitted

    def uses_dsc(self) -> bool:
        return (any(isinstance(s, DSCCompress) for s in self.compress)
                or isinstance(self.aggregate, DSCAggregate)
                or getattr(self.aggregate, "use_dsc", False))

    def init_state(self, x0: torch.Tensor, K: int) -> RoundState:
        n = x0.shape[0]
        dsc = (dsc_lib.init_state(K, n, device=x0.device)
               if self.uses_dsc() else None)
        return RoundState(x0, dsc, self.server.init(x0))

    def run_round(self, grad_fn: Callable, seeds: RoundSeeds,
                  state: RoundState, batches, K: int,
                  collect_views: bool = False
                  ) -> tuple[RoundState, Optional[torch.Tensor]]:
        """One round.  Returns (new_state, adversary_views); the views are
        kept only when ``collect_views`` asks for them (the transmitted
        (K, n) stack under ``view='transmitted'``, or the aggregate
        stage's override)."""
        kept: List[torch.Tensor] = []

        def transmitted():
            # no enumerate: it keeps its last item until the next one is
            # made, i.e. client k's gradient through client k + 1's
            k = 0
            for v in self.client(grad_fn, state.x, batches, K):
                for stage in self.compress:
                    v = stage.apply(seeds, state, v, k)
                if collect_views and self.view == "transmitted":
                    kept.append(v)
                yield v
                del v       # dropped before client k + 1's gradient
                k += 1

        agg = self.aggregate.apply(seeds, state, transmitted(), K)
        new_state = self.server.apply(agg.state, agg.update)
        if not collect_views:
            return new_state, None
        views = agg.views if agg.views is not None else (
            torch.stack(kept) if kept else None)
        return new_state, views
