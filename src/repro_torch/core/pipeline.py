"""The FL round as a stage graph (``repro/core/pipeline.py``, the paper's
Algorithm 1), synchronous stages only:

    ClientStep      local gradients                       (Alg. 1 line 3)
    CompressStage*  what leaves the client                (line 4: DSC,
                    error feedback, the int8 wire)
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
error-feedback state without EF.

Randomness.  As in the reference, every round splits its key into role
keys (:func:`split_round_keys`, from ``repro_torch.random``'s threefry
stream) and each stage takes the role it consumes: the dense compressors
draw with their keys, the wire kernels take uint32 seeds
``_seed_of(key)``.  Client k of a stage whose reference vmaps the
clients uses ``split(key, K)[k]``, the key the reference's vmap hands
it.

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

from repro_torch import random
from repro_torch.core import dsc as dsc_lib
from repro_torch.core import error_feedback as ef_lib
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
    ef: Optional[ef_lib.EFState] = None  # None unless a stage uses EF


class RoundKeys(NamedTuple):
    """A round's role keys, as the reference splits them: the five-way
    split, the two sub-keys of ``comp`` and a wire key folded from it."""
    mask: torch.Tensor
    comp: torch.Tensor
    noise: torch.Tensor
    fail: torch.Tensor
    part: torch.Tensor
    comp0: torch.Tensor      # split(comp)[0]
    comp1: torch.Tensor      # split(comp)[1]
    wire: torch.Tensor       # wire-format stages (int8 quantization)


def split_round_keys(key: torch.Tensor) -> RoundKeys:
    k_mask, k_comp, k_noise, k_fail, k_part = random.split(key, 5)
    c0, c1 = random.split(k_comp)
    return RoundKeys(k_mask, k_comp, k_noise, k_fail, k_part, c0, c1,
                     random.fold_in(k_comp, 0x3177))


def participation_weights(key: torch.Tensor, K: int, fraction: float
                          ) -> Optional[torch.Tensor]:
    """Client-sampling weights: Bernoulli(fraction) per client with one
    participant forced (None when everyone participates)."""
    if fraction >= 1.0:
        return None
    k_draw, k_force = random.split(key)
    part = random.bernoulli(k_draw, fraction, (K,))
    part[int(random.randint(k_force, (), 0, K))] = True
    return part.float()


def _seed_of(key: torch.Tensor) -> int:
    """A kernel's uint32 seed: ``bits(key)``."""
    return int(random.bits(key))


def _client_key(key: torch.Tensor, state: RoundState, k: int
                ) -> torch.Tensor:
    """Client k's key, as the reference's vmap over ``split(key, K)``."""
    K = (state.dsc.s_clients if state.dsc is not None else state.ef.e
         ).shape[0]
    return random.split(key, K)[k]


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

    def apply(self, keys: RoundKeys, state: RoundState, v: torch.Tensor,
              k: int) -> torch.Tensor:
        return v


@dataclasses.dataclass(frozen=True)
class DSCCompress(CompressStage):
    """Distributed shifted compression, client side (Sec. 3.2.2):
    v_k = C(g_k - s_k);  s_k <- s_k + gamma v_k, s_k updated in place.

    ``impl='jnp'`` (the reference's default) runs the dense compressor,
    its draws from the threefry stream with client k's key
    ``split(keys.comp, K)[k]`` (``dsc.compress_client``; RandP chunk by
    chunk).  ``impl='pallas'`` runs a RandP compressor through the
    ``dsc_update`` kernel; ``impl='fused'`` runs ``Int8RoundTrip(RandP)``
    (or RandP) through the one-pass ``dsc_quantize`` kernel and
    transmits the dequantized wire value, which the shift tracks.  The
    kernels take ``_seed_of`` the round's ``comp`` key (fused: of its two
    halves)."""

    compressor: Compressor = Identity()
    gamma: float = 0.0
    impl: str = "jnp"            # jnp | pallas | fused

    def __post_init__(self):
        if self.impl not in ("jnp", "pallas", "fused"):
            raise ValueError(f"unknown DSC impl {self.impl!r}")
        if self.impl == "jnp":
            return
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

    def apply(self, keys, state, g, k):
        s = state.dsc.s_clients[k]
        n = g.numel()
        if self.impl == "jnp":
            return dsc_lib.compress_client(
                s, g, self.compressor, self.gamma,
                _client_key(keys.comp, state, k))
        if self.impl == "pallas":
            v, _ = du_kernel.dsc_update(
                g, s, _seed_of(keys.comp), p=self.p, gamma=self.gamma,
                index_base=k * q_kernel.padded(n, du_kernel.LANES), out=s)
            return v
        k_in, k_q = random.split(keys.comp)
        q, scales, _ = dq_kernel.dsc_quantize(
            g, s, _seed_of(k_in), _seed_of(k_q), p=self.p,
            gamma=self.gamma,
            index_base=k * q_kernel.padded(n), out=s)
        # the simulator aggregates in f32, so reconstruct the wire value
        return q_kernel.dequantize(q, scales)[:n]

    def apply_leaf(self, key: torch.Tensor, g: torch.Tensor,
                   s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Single-client, single-leaf form for the distributed step (each
        rank holds its own s_k leaf): v = C(g.to(s.dtype) - s) with the
        compressor's draws from ``key``, and s + gamma v, which XLA fuses
        into one FMA for an f32 s (``dsc.fma_shift``).  s is not
        modified.  Returns (v, s_new)."""
        v = self.compressor(key, g.to(s.dtype) - s)
        return v, dsc_lib.fma_shift(self.gamma, v, s)


@dataclasses.dataclass(frozen=True)
class Int8Wire(CompressStage):
    """Beyond-paper wire format: per-256-block stochastic int8
    quantize -> dequantize round trip on the ``quantize`` kernels."""

    def apply(self, keys, state, v, k):
        n = v.numel()
        q, scales = q_kernel.quantize(
            v, _seed_of(keys.wire), index_base=k * q_kernel.padded(n))
        return q_kernel.dequantize(q, scales)[:n]


@dataclasses.dataclass(frozen=True)
class EFCompress(CompressStage):
    """EF21-style error feedback for BIASED compressors:
    v_k = C(g_k + e_k);  e_k <- g_k + e_k - v_k, client k with key
    ``split(keys.comp, K)[k]`` (``core/error_feedback.py``)."""

    compressor: Compressor = Identity()

    def apply(self, keys, state, g, k):
        return ef_lib.compress_client(state.ef.e[k], g, self.compressor,
                                      _client_key(keys.comp, state, k))


# ============================================================== aggregate
class AggregateResult(NamedTuple):
    update: torch.Tensor                  # aggregated pseudo-gradient (n,)
    state: RoundState
    views: Optional[torch.Tensor] = None  # adversary-view override


@dataclasses.dataclass(frozen=True)
class AggregateStage:
    """Base: exact weighted mean, FedAvg's all-reduce and equally FSA's
    algebraic form (Theorem B.1).  ``vs`` yields the K transmitted
    vectors one at a time; ``weights`` are the round's participation
    weights (None: every client weighs 1/K)."""

    def apply(self, keys: RoundKeys, state: RoundState,
              vs: Iterator[torch.Tensor], K: int,
              weights: Optional[torch.Tensor] = None) -> AggregateResult:
        return AggregateResult(fsa_lib.weighted_sum(vs, weights, K=K), state)


@dataclasses.dataclass(frozen=True)
class DSCAggregate(AggregateStage):
    """Aggregator-side shift compensation (Eq. 4):
    u = s_agg + mean_k v_k;  s_agg <- s_agg + gamma mean_k v_k."""

    gamma: float = 0.0

    def apply(self, keys, state, vs, K, weights=None):
        u, _ = dsc_lib.aggregate(state.dsc, vs, self.gamma, K=K,
                                 weights=weights)
        return AggregateResult(u, state)


@dataclasses.dataclass(frozen=True)
class FSASharded(AggregateStage):
    """Literal Algorithm 1 lines 5-13: per-aggregator masked shards,
    aggregated independently and reassembled; iterate-identical to the
    mean (Theorem B.1), and it exposes the aggregators' views.  It holds
    all K vectors (and, with ``keep_views``, the (A, K, n) views), so it
    is for simulator sizes.  ``fresh_masks`` draws a new random
    assignment every round (the paper's m^t) with the round's ``mask``
    key."""

    A: int = 4
    mask_scheme: str = "strided"
    keep_views: bool = True
    fresh_masks: bool = False
    use_dsc: bool = False
    gamma: float = 0.0

    def assignment(self, keys: RoundKeys, n: int, device) -> torch.Tensor:
        if self.fresh_masks:
            return masks_lib.make_assignment(n, self.A, "random",
                                             key=keys.mask, device=device)
        return masks_lib.make_assignment(n, self.A, self.mask_scheme,
                                         device=device)

    def apply(self, keys, state, vs, K, weights=None):
        v = torch.stack(list(vs))
        n = v.shape[1]
        assign = self.assignment(keys, n, v.device)
        out = fsa_lib.fsa_round_sharded(
            torch.zeros(n, device=v.device), v, assign, self.A, 1.0,
            weights=weights, keep_views=self.keep_views)
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

    def uses_ef(self) -> bool:
        return any(isinstance(s, EFCompress) for s in self.compress)

    def init_state(self, x0: torch.Tensor, K: int) -> RoundState:
        n = x0.shape[0]
        dsc = (dsc_lib.init_state(K, n, device=x0.device)
               if self.uses_dsc() else None)
        ef = (ef_lib.init_state(K, n, device=x0.device)
              if self.uses_ef() else None)
        return RoundState(x0, dsc, self.server.init(x0), ef)

    def run_round(self, grad_fn: Callable, keys: RoundKeys,
                  state: RoundState, batches, K: int,
                  weights: Optional[torch.Tensor] = None,
                  collect_views: bool = False
                  ) -> tuple[RoundState, Optional[torch.Tensor]]:
        """One round.  Every client computes and compresses (its shift or
        residual moves whether or not it participates, as in the
        reference); ``weights`` weigh the aggregation.  Returns
        (new_state, adversary_views); the views are kept only when
        ``collect_views`` asks for them (the transmitted (K, n) stack
        under ``view='transmitted'``, or the aggregate stage's
        override)."""
        kept: List[torch.Tensor] = []

        def transmitted():
            # no enumerate: it keeps its last item until the next one is
            # made, i.e. client k's gradient through client k + 1's
            k = 0
            for v in self.client(grad_fn, state.x, batches, K):
                for stage in self.compress:
                    v = stage.apply(keys, state, v, k)
                if collect_views and self.view == "transmitted":
                    kept.append(v)
                yield v
                del v       # dropped before client k + 1's gradient
                k += 1

        agg = self.aggregate.apply(keys, state, transmitted(), K, weights)
        new_state = self.server.apply(agg.state, agg.update)
        if not collect_views:
            return new_state, None
        views = agg.views if agg.views is not None else (
            torch.stack(kept) if kept else None)
        return new_state, views
