"""The FL round as a stage graph (``repro/core/pipeline.py``, the paper's
Algorithm 1):

    ClientStep      local gradients                       (Alg. 1 line 3)
    CompressStage*  what leaves the client                (line 4: DSC,
                    error feedback, LDP noise, pruning, pairwise masks,
                    the int8 wire)
    AggregateStage  how shards meet                       (lines 5-13: FSA
                    sharded or algebraic, secure-agg, shatter,
                    failure-injected FSA, FedBuff-style buffering)
    ServerStage     how the global model moves            (line 14)

The reference vmaps the K clients into (K, n) arrays.  Here a round
streams them: for client k it takes the gradient at the shared x, runs it
through the compress stages (which update client k's row of the shift
state in place) and hands the transmitted vector to the aggregate stage,
which folds it into one f32 accumulator.  The values are the reference's;
the memory is one client's vectors at a time, so a round of
eris-gptneo-1.3b (n = 1.8e9) fits one 80 GB card.  Only what the
configuration uses is allocated: no shift state without DSC, no
error-feedback state without EF, no buffer without buffered
aggregation.  The stages whose reference draws a (K, n) array (LDP
noise, the pairwise masks) draw client k's window of it, and those that
need a per-coordinate table (shatter's weights, the failure-injected
assignment) build it a window of coordinates at a time.

Randomness.  As in the reference, every round splits its key into role
keys (:func:`split_round_keys`, from ``repro_torch.random``'s threefry
stream) and each stage takes the role its ``key_role`` names (the
reference's defaults): the dense compressors
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
from repro_torch.core import baselines as bl
from repro_torch.core import dsc as dsc_lib
from repro_torch.core import error_feedback as ef_lib
from repro_torch.core import fsa as fsa_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core import secure_agg as sa_lib
from repro_torch.core import server_opt as so_lib
from repro_torch.core.compressors import (Compressor, Identity,
                                          Int8RoundTrip, RandP)
from repro_torch.kernels import dsc_quantize as dq_kernel
from repro_torch.kernels import dsc_update as du_kernel
from repro_torch.kernels import quantize as q_kernel


# ================================================================== state
class BufferState(NamedTuple):
    """FedBuff-style aggregator buffer carried across rounds: the
    staleness-weighted update accumulator, its cumulative weight and the
    round counter driving the server-apply cadence."""
    u: torch.Tensor          # weighted update accumulator (n,) f32
    w: torch.Tensor          # cumulative arrival weight, 0-d f32 (host)
    t: int                   # rounds folded since start


def init_buffer(n: int, device=None) -> BufferState:
    return BufferState(torch.zeros(n, device=device), torch.zeros(()), 0)


class RoundState(NamedTuple):
    """Everything a round carries forward."""
    x: torch.Tensor                      # global model (n,)
    dsc: Optional[dsc_lib.DSCState]      # None unless a stage uses DSC
    server: Any                          # server optimizer state
    ef: Optional[ef_lib.EFState] = None  # None unless a stage uses EF
    buf: Optional[BufferState] = None    # under buffered aggregation


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


def _cohort_size(state: RoundState, K: Optional[int]) -> int:
    if K is not None:
        return K
    if state.dsc is not None:
        return state.dsc.s_clients.shape[0]
    if state.ef is not None:
        return state.ef.e.shape[0]
    raise ValueError("this stage needs the cohort size K")


def _client_key(key: torch.Tensor, state: RoundState, k: int,
                K: Optional[int] = None) -> torch.Tensor:
    """Client k's key, as the reference's vmap over ``split(key, K)``."""
    return random.split(key, _cohort_size(state, K))[k]


def client_batch(batches, k):
    """Client k's slice of a pytree of per-client batches (leading K);
    ``k`` may be an index tensor, which gathers those rows."""
    if isinstance(batches, dict):
        return {name: client_batch(b, k) for name, b in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(client_batch(b, k) for b in batches)
    if isinstance(k, torch.Tensor):
        return batches.index_select(0, k.to(batches.device))
    return batches[k]


# ======================================================= async primitives
# Key salts: BufferedAggregate folds its role key with ARRIVAL_SALT and
# CohortSample with COHORT_SALT, so the arrival and cohort draws are
# decorrelated from every other consumer of the same role key;
# PairwiseMask folds its role key with PAIRWISE_SALT, so composed with
# LDPNoise (same "noise" role) the mask and noise streams differ.
ARRIVAL_SALT = 0xA51C
COHORT_SALT = 0xC0C0
PAIRWISE_SALT = 0x6D5C


@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """Keyed straggler/dropout arrivals (the FedBuff-style async client
    model): each cohort member arrives with staleness ``tau ~
    U{0..delay_max}`` and survives dropout w.p. ``1 - dropout``; its
    update is weighted ``1/(1+tau)^alpha`` and a dropped client
    contributes nothing."""

    delay_max: int = 0
    dropout: float = 0.0
    alpha: float = 1.0

    @property
    def trivial(self) -> bool:
        """No staleness and no dropout: no draws, every arrival weighs
        exactly 1.0, so buffered aggregation is the synchronous path bit
        for bit."""
        return self.delay_max == 0 and self.dropout == 0.0

    def staleness_weight(self, tau: torch.Tensor) -> torch.Tensor:
        return (1.0 + tau.float()) ** (-self.alpha)

    def draw(self, key: torch.Tensor, K: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tau, alive, weight) for a K-client cohort, on the host."""
        kd, ka = random.split(key)
        tau = random.randint(kd, (K,), 0, self.delay_max + 1)
        alive = random.bernoulli(ka, 1.0 - self.dropout, (K,))
        omega = self.staleness_weight(tau) * alive.float()
        return tau, alive, omega


@dataclasses.dataclass(frozen=True)
class CohortSample:
    """A round's cohort drawn from a population: a keyed
    without-replacement sample of ``cohort`` client ids out of
    ``population`` (a threefry permutation of the round's role key)."""

    population: int
    cohort: int
    key_role: str = "part"

    def __post_init__(self):
        if not 0 < self.cohort <= self.population:
            raise ValueError(
                f"cohort size {self.cohort} must be in 1..population "
                f"({self.population})")

    def draw(self, keys: RoundKeys) -> torch.Tensor:
        key = random.fold_in(getattr(keys, self.key_role), COHORT_SALT)
        return random.permutation(key, self.population)[:self.cohort]

    def gather(self, keys: RoundKeys, batches):
        """The cohort's rows of population-leading batches (leading dim
        population -> cohort), gathered before the client loop."""
        idx = self.draw(keys)
        return idx, client_batch(batches, idx)


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
    client k's vector to what it transmits, updating the state in place;
    K is the cohort size (the round passes it)."""

    key_role: str = "comp"

    def _key(self, keys: RoundKeys) -> torch.Tensor:
        return getattr(keys, self.key_role)

    def apply(self, keys: RoundKeys, state: RoundState, v: torch.Tensor,
              k: int, K: Optional[int] = None) -> torch.Tensor:
        return v


@dataclasses.dataclass(frozen=True)
class LDPNoise(CompressStage):
    """Per-client clip + Gaussian perturbation (LDP-FL / SoteriaFL's
    privacy mechanism): client k's row of the reference's (K, n) noise
    draw (``baselines.ldp_perturb_client``)."""

    ldp: bl.LDPConfig = bl.LDPConfig()
    key_role: str = "noise"

    def apply(self, keys, state, v, k, K=None):
        return bl.ldp_perturb_client(self._key(keys), v, self.ldp, k,
                                     _cohort_size(state, K))


@dataclasses.dataclass(frozen=True)
class DSCCompress(CompressStage):
    """Distributed shifted compression, client side (Sec. 3.2.2):
    v_k = C(g_k - s_k);  s_k <- s_k + gamma v_k, s_k updated in place.

    ``impl='jnp'`` (the reference's default) runs the dense compressor,
    its draws from the threefry stream with client k's key
    ``split(key, K)[k]`` (``dsc.compress_client``; RandP chunk by
    chunk).  ``impl='pallas'`` runs a RandP compressor through the
    ``dsc_update`` kernel; ``impl='fused'`` runs ``Int8RoundTrip(RandP)``
    (or RandP) through the one-pass ``dsc_quantize`` kernel and
    transmits the dequantized wire value, which the shift tracks.  The
    kernels take ``_seed_of`` the role key (fused: of its two halves)."""

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

    def apply(self, keys, state, g, k, K=None):
        s = state.dsc.s_clients[k]
        n = g.numel()
        key = self._key(keys)
        if self.impl == "jnp":
            return dsc_lib.compress_client(
                s, g, self.compressor, self.gamma,
                _client_key(key, state, k, K))
        if self.impl == "pallas":
            v, _ = du_kernel.dsc_update(
                g, s, _seed_of(key), p=self.p, gamma=self.gamma,
                index_base=k * q_kernel.padded(n, du_kernel.LANES), out=s)
            return v
        k_in, k_q = random.split(key)
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
class EFCompress(CompressStage):
    """EF21-style error feedback for BIASED compressors:
    v_k = C(g_k + e_k);  e_k <- g_k + e_k - v_k, client k with key
    ``split(key, K)[k]`` (``core/error_feedback.py``)."""

    compressor: Compressor = Identity()

    def apply(self, keys, state, g, k, K=None):
        return ef_lib.compress_client(state.ef.e[k], g, self.compressor,
                                      _client_key(self._key(keys), state, k,
                                                  K))


@dataclasses.dataclass(frozen=True)
class PruneWithhold(CompressStage):
    """PriPrune-style defense: withhold (zero) the top-|g| fraction of
    each client's update before transmission, the threshold found by an
    exact selection (``baselines.withhold_threshold``)."""

    rate: float = 0.1

    def apply(self, keys, state, v, k, K=None):
        return bl.prune_client(v, self.rate)


@dataclasses.dataclass(frozen=True)
class Int8Wire(CompressStage):
    """Beyond-paper wire format: per-256-block stochastic int8
    quantize -> dequantize round trip on the ``quantize`` kernels."""

    key_role: str = "wire"

    def apply(self, keys, state, v, k, K=None):
        n = v.numel()
        q, scales = q_kernel.quantize(
            v, _seed_of(self._key(keys)), index_base=k * q_kernel.padded(n))
        return q_kernel.dequantize(q, scales)[:n]


@dataclasses.dataclass(frozen=True)
class PairwiseMask(CompressStage):
    """Bonawitz pairwise masking as a wire stage (the composed-defense
    form): client k adds its row of the fixed-point pairwise mask grid
    before transmission, so every downstream aggregator view is masked,
    while the masks cancel exactly in the unweighted full-cohort sum.
    Partial participation, dropout or link failure leave unpaired masks
    in the aggregate: ``rounds.scenarios`` and the registry refuse those
    compositions."""

    scale: float = 100.0
    key_role: str = "noise"

    def apply(self, keys, state, v, k, K=None):
        key = random.fold_in(self._key(keys), PAIRWISE_SALT)
        return sa_lib.mask_row_update(key, v, k, _cohort_size(state, K),
                                      self.scale)


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
    weights (None, or ``use_weights=False``: every client weighs 1/K).
    ``collect_views`` asks a stage whose adversary view is per-client
    (secure aggregation's masked updates) to keep it."""

    use_weights: bool = True
    key_role: str = "comp"

    def _key(self, keys: RoundKeys) -> torch.Tensor:
        return getattr(keys, self.key_role)

    def _w(self, weights: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return weights if self.use_weights else None

    def apply(self, keys: RoundKeys, state: RoundState,
              vs: Iterator[torch.Tensor], K: int,
              weights: Optional[torch.Tensor] = None,
              collect_views: bool = False) -> AggregateResult:
        return AggregateResult(fsa_lib.weighted_sum(vs, self._w(weights),
                                                    K=K), state)


@dataclasses.dataclass(frozen=True)
class DSCAggregate(AggregateStage):
    """Aggregator-side shift compensation (Eq. 4):
    u = s_agg + mean_k v_k;  s_agg <- s_agg + gamma mean_k v_k."""

    gamma: float = 0.0

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        u, _ = dsc_lib.aggregate(state.dsc, vs, self.gamma, K=K,
                                 weights=self._w(weights))
        return AggregateResult(u, state)


def _compensate(state: RoundState, mean_v: torch.Tensor, use_dsc: bool,
                gamma: float) -> torch.Tensor:
    """Eq. 4 on the sharded mean when ``use_dsc``: u = s_agg + mean;
    s_agg += gamma mean, in place.  Else u = mean."""
    if not use_dsc:
        return mean_v
    s_agg = state.dsc.s_agg
    u = s_agg + mean_v
    s_agg.add_(mean_v, alpha=gamma)
    return u


@dataclasses.dataclass(frozen=True)
class FSASharded(AggregateStage):
    """Literal Algorithm 1 lines 5-13: per-aggregator masked shards,
    aggregated independently and reassembled; iterate-identical to the
    mean (Theorem B.1), and it exposes the aggregators' views.  It holds
    all K vectors (and, with ``keep_views``, the (A, K, n) views), so it
    is for simulator sizes.  ``fresh_masks`` draws a new random
    assignment every round (the paper's m^t) with the round's ``mask``
    key.  ``assign_override`` pins the coordinate->aggregator assignment
    to an explicit (n,) vector, ahead of ``fresh_masks`` and the scheme:
    the privacy audit attacks the simulator under the distributed step's
    per-leaf segment layout (``privacy.views.mesh_flat_assignment``), so
    that the per-aggregator views of the two engines line up."""

    A: int = 4
    mask_scheme: str = "strided"
    keep_views: bool = True
    fresh_masks: bool = False
    use_dsc: bool = False
    gamma: float = 0.0
    key_role: str = "mask"
    assign_override: Optional[torch.Tensor] = None

    def assignment(self, keys: RoundKeys, n: int, device) -> torch.Tensor:
        if self.assign_override is not None:
            return torch.as_tensor(self.assign_override).to(device)
        if self.fresh_masks:
            return masks_lib.make_assignment(n, self.A, "random",
                                             key=self._key(keys),
                                             device=device)
        return masks_lib.make_assignment(n, self.A, self.mask_scheme,
                                         device=device)

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        v = torch.stack(list(vs))
        n = v.shape[1]
        assign = self.assignment(keys, n, v.device)
        out = fsa_lib.fsa_round_sharded(
            torch.zeros(n, device=v.device), v, assign, self.A, 1.0,
            weights=self._w(weights), keep_views=self.keep_views)
        u = _compensate(state, -out.x_new, self.use_dsc, self.gamma)
        return AggregateResult(u, state, out.shard_views)


@dataclasses.dataclass(frozen=True)
class SecureAggAggregate(AggregateStage):
    """Bonawitz-style pairwise masking: the aggregate is the mean of the
    masked updates (each rounded in f32 as the reference's), the
    adversary view the masked per-client updates.  The masks cancel only
    in the unweighted full-cohort mean, and this simplified protocol has
    no dropout recovery, so any weights raise."""

    use_weights: bool = False

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        if weights is not None:
            raise ValueError(
                "secure_agg cannot aggregate a weighted/partial cohort: "
                "pairwise masks cancel only in the unweighted full-cohort "
                "mean, and this simplified Bonawitz protocol has no "
                "dropout-recovery round (run with participation=1.0 / "
                "no client dropout, or pick a different defense)")
        key = self._key(keys)
        kept: List[torch.Tensor] = []

        def masked():
            k = 0
            for v in vs:
                m = sa_lib.mask_row_update(key, v, k, K)
                if collect_views:
                    kept.append(m)
                yield m
                del v, m
                k += 1

        u = fsa_lib.mean_rows(masked())
        return AggregateResult(u, state, torch.stack(kept) if kept else None)


@dataclasses.dataclass(frozen=True)
class ShatterAggregate(AggregateStage):
    """ShatterLite: coordinates in contiguous chunks, each chunk averaged
    over a random r-subset of clients (a gossip-neighborhood
    approximation; intentionally not the full mean).  Each client folds
    into one accumulator, its per-coordinate weight looked up a window
    at a time (``baselines.shatter_chunk_window``, the reference's int32
    chunk ids)."""

    chunks: int = 8
    r: int = 4

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        acc, members = None, None
        k = 0
        for v in vs:
            n = v.numel()
            if acc is None:
                acc = torch.zeros(n, dtype=torch.float32, device=v.device)
                members = bl.shatter_members(self._key(keys), self.chunks, K,
                                             self.r, v.device)
            for lo in range(0, n, random.CHUNK):
                hi = min(n, lo + random.CHUNK)
                c = bl.shatter_chunk_window(n, self.chunks, lo, hi, v.device)
                acc[lo:hi] += members[c, k] * v[lo:hi]
            del v
            k += 1
        return AggregateResult(acc, state)


@dataclasses.dataclass(frozen=True)
class FailureInjectedFSA(AggregateStage):
    """Appendix F.5: aggregator dropout and client->aggregator link
    failures on the transmitted shards; with ``use_dsc`` the Eq. 4
    compensation uses what the aggregators received.  Client k folds
    into one accumulator, weighted link_alive[k, a(i)] / cnt[a(i)] at
    coordinate i, which is zeroed where aggregator a(i) is down (the
    reference's ``fsa_round_with_failures`` on (A, K, n) shards).
    ``keep_views`` also builds the (A, K, n) received shards
    (link-failed and dead entries zeroed), at simulator sizes."""

    A: int = 4
    mask_scheme: str = "strided"
    agg_dropout: float = 0.0
    link_failure: float = 0.0
    use_dsc: bool = False
    gamma: float = 0.0
    key_role: str = "fail"
    keep_views: bool = False

    def draws(self, keys: RoundKeys, K: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(agg_alive (A,), link_alive (K, A)), on the host."""
        ka, kl = random.split(self._key(keys))
        return (random.bernoulli(ka, 1.0 - self.agg_dropout, (self.A,)),
                random.bernoulli(kl, 1.0 - self.link_failure, (K, self.A)))

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        agg_alive, link_alive = self.draws(keys, K)
        w = link_alive.T.float()                             # (A, K)
        coef = w / torch.clamp(w.sum(1, keepdim=True), min=1.0)
        acc, kept = None, []
        k = 0
        for v in vs:
            if acc is None:
                acc = torch.zeros(v.numel(), dtype=torch.float32,
                                  device=v.device)
                w, coef = w.to(v.device), coef.to(v.device)
                alive = agg_alive.float().to(v.device)
            for lo, hi, a, owned in self._windows(acc):
                acc[lo:hi] += torch.where(owned, coef[a, k], 0.0) * v[lo:hi]
            if self.keep_views:
                kept.append(v)
            del v
            k += 1
        for lo, hi, a, owned in self._windows(acc):
            acc[lo:hi] *= torch.where(owned, alive[a], 0.0)
        views = None
        if self.keep_views:
            m = masks_lib.masks_stacked(masks_lib.make_assignment(
                acc.numel(), self.A, self.mask_scheme, device=acc.device),
                self.A)
            views = (m[:, None, :] * torch.stack(kept)[None]
                     * w[:, :, None] * alive[:, None, None])
        u = _compensate(state, acc, self.use_dsc, self.gamma)
        return AggregateResult(u, state, views)

    def _windows(self, acc: torch.Tensor):
        """(lo, hi, aggregator, owned) over acc's coordinates a window at
        a time; a coordinate with a negative assignment (the contiguous
        scheme's int32 wrap) is owned by no aggregator."""
        n = acc.numel()
        for lo in range(0, n, random.CHUNK):
            hi = min(n, lo + random.CHUNK)
            a = masks_lib.assignment_window(n, self.A, self.mask_scheme, lo,
                                            hi, acc.device)
            yield lo, hi, a.clamp(min=0).long(), a >= 0


@dataclasses.dataclass(frozen=True)
class BufferedAggregate(AggregateStage):
    """FedBuff-style buffered asynchronous aggregation around any inner
    aggregate stage: arrivals (drawn from ``arrival``) fold their
    staleness-weighted updates into a cross-round :class:`BufferState`;
    the server consumes the buffer every ``cadence`` rounds and the
    update is zero in between.

    The inner stage aggregates the arrived cohort with weights ``base_k *
    omega_k``, the buffer accumulates ``W_r * contrib`` with the round's
    arrival mass ``W_r = sum(base omega) / sum(base)``, and an apply
    round emits ``buf.u / buf.w`` and resets.  With the trivial arrival
    model and ``cadence=1`` each step is ``0 + 1.0 u`` and ``u / 1.0``,
    so the async path is the synchronous inner stage bit for bit.  A
    dropped client's row is multiplied by 0 (its gradient is still taken:
    an inf row gives NaN, as in the reference) and its views zeroed."""

    inner: AggregateStage = AggregateStage()
    arrival: ArrivalModel = ArrivalModel()
    cadence: int = 1
    key_role: str = "fail"

    def __post_init__(self):
        if self.cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {self.cadence}")
        if not self.inner.use_weights:
            raise ValueError(
                "BufferedAggregate needs an inner aggregate with "
                "use_weights=True; otherwise staleness/dropout weights "
                "would be silently ignored")

    def init_buffer(self, n: int, device=None) -> BufferState:
        return init_buffer(n, device)

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        if state.buf is None:
            raise ValueError("BufferedAggregate needs RoundState.buf — "
                             "initialize via RoundPipeline.init_state "
                             "(or pipeline.init_buffer)")
        if self.arrival.trivial:
            res = self.inner.apply(keys, state, vs, K, weights,
                                   collect_views)
            contrib, views = res.update, res.views
            w_round = torch.ones(())
        else:
            k_arr = random.fold_in(self._key(keys), ARRIVAL_SALT)
            _, alive, omega = self.arrival.draw(k_arr, K)
            base = (weights.float().cpu() if weights is not None
                    and self.use_weights else torch.ones(K))
            w_eff = base * omega
            w_sum = w_eff.sum()
            arrived = w_sum > 0

            def received():
                # dropped clients transmitted nothing: their rows times 0
                k = 0
                for v in vs:
                    yield v if alive[k] else v * 0.0
                    del v
                    k += 1

            res = self.inner.apply(keys, state, received(), K,
                                   w_eff if arrived else torch.ones(K),
                                   collect_views)
            w_round = w_sum / base.sum() if arrived else torch.zeros(())
            contrib = res.update if arrived else torch.zeros_like(res.update)
            views = res.views
            if views is not None:
                a = alive.to(views.device, views.dtype)
                views = views * (a[None, :, None] if views.ndim == 3
                                 else a[:, None])
        buf = state.buf
        u_acc = buf.u.add_(contrib, alpha=float(w_round))
        w_acc = buf.w + w_round
        t_new = buf.t + 1
        if t_new % self.cadence == 0:
            update = u_acc / float(torch.clamp(w_acc, min=1e-12))
            u_acc.zero_()
            buf_new = BufferState(u_acc, torch.zeros(()), t_new)
        else:
            update = torch.zeros_like(u_acc)
            buf_new = BufferState(u_acc, w_acc, t_new)
        return AggregateResult(update, res.state._replace(buf=buf_new),
                               views)


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
    vectors, an aggregate-stage override, or nothing.  With a ``cohort``
    the round's batches carry the whole population on their leading
    axis and the drawn cohort's rows are stepped."""

    client: ClientStep = ClientStep()
    compress: tuple = ()
    aggregate: AggregateStage = AggregateStage()
    server: ServerStage = ServerStage()
    view: str = "none"           # none | transmitted
    cohort: Optional[CohortSample] = None

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
        buf = (self.aggregate.init_buffer(n, x0.device)
               if isinstance(self.aggregate, BufferedAggregate) else None)
        return RoundState(x0, dsc, self.server.init(x0), ef, buf)

    def aggregate_round(self, grad_fn: Callable, keys: RoundKeys,
                        state: RoundState, batches, K: int,
                        weights: Optional[torch.Tensor] = None,
                        collect_views: bool = False,
                        keep_transmitted: bool = False
                        ) -> tuple[AggregateResult, Optional[torch.Tensor]]:
        """The round up to the server: every client computes and
        compresses (its shift or residual moves whether or not it
        participates, as in the reference), the aggregate stage folds
        the transmitted vectors (``collect_views`` asks it for its
        adversary view).  Returns (the aggregate's result, the
        transmitted (K, n) stack when ``keep_transmitted``, else None)."""
        if self.cohort is not None:
            _, batches = self.cohort.gather(keys, batches)
        kept: List[torch.Tensor] = []

        def transmitted():
            # no enumerate: it keeps its last item until the next one is
            # made, i.e. client k's gradient through client k + 1's
            k = 0
            for v in self.client(grad_fn, state.x, batches, K):
                for stage in self.compress:
                    v = stage.apply(keys, state, v, k, K)
                if keep_transmitted:
                    kept.append(v)
                yield v
                del v       # dropped before client k + 1's gradient
                k += 1

        agg = self.aggregate.apply(keys, state, transmitted(), K, weights,
                                   collect_views)
        return agg, torch.stack(kept) if kept else None

    def run_round(self, grad_fn: Callable, keys: RoundKeys,
                  state: RoundState, batches, K: int,
                  weights: Optional[torch.Tensor] = None,
                  collect_views: bool = False
                  ) -> tuple[RoundState, Optional[torch.Tensor]]:
        """One round: :meth:`aggregate_round`, then the server.  Returns
        (new_state, adversary_views); the views are kept only when
        ``collect_views`` asks for them (the aggregate stage's override,
        or the transmitted (K, n) stack under ``view='transmitted'``)."""
        agg, sent = self.aggregate_round(
            grad_fn, keys, state, batches, K, weights, collect_views,
            keep_transmitted=collect_views and self.view == "transmitted")
        new_state = self.server.apply(agg.state, agg.update)
        if not collect_views:
            return new_state, None
        return new_state, agg.views if agg.views is not None else sent
