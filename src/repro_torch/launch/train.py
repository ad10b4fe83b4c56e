"""Distributed train step (``repro/launch/train.py``): FSA as explicit
collectives over ``torch.distributed``, on the data and model axes.

One process per mesh position: on the data axis rank a is client group a
AND aggregator a.  One step:

  1. *FSA broadcast* -- the stored parameters are sharded over the ranks
     (each rank owns one aggregator's disjoint segment, Sec. 3.2.1); an
     all-gather of every sharded leaf rebuilds x^t = sum_a m_(a) . x^t_(a)
     (Algorithm 1 line 14).
  2. *Local update* -- each rank takes the gradient of its client group's
     rows of the global batch.
  3. *DSC (optional)* -- each client group shift-compresses its update,
     v_k = C(g_k - s_k), s_k += gamma v_k, before transmission.
  4. *FSA aggregation* -- the reduce-scatter stage, in one of two wire
     formats:
       * ``grad_dtype`` (default bf16): a reduce-scatter over the ranks;
         each aggregator receives and reduces ONLY its disjoint segment
         (Theorem B.1: all_reduce == all_gather . reduce_scatter).
       * ``int8_wire``: each segment is quantized per-256-block
         (stochastic int8 + f32 scales, the ``quantize`` kernels; with
         DSC the fused ``dsc_quantize`` kernel), codes and scales cross
         the group by ``all_to_all_single`` (a sum cannot be taken in the
         quantized domain), and each aggregator dequantizes and averages
         what it received.
  5. *Shard-local optimizer* -- aggregator a updates x_(a); the optimizer
     state lives sharded like the parameters (never gathered).

With ``fsa=False`` the FedAvg schedule runs instead: an all-reduce mean of
the gradients and a replicated optimizer.

The scenario and async knobs (the ``rounds.scenarios`` matrix on the mesh
wire) ride the same step, leaf by leaf in the reference's order: LDP
(each rank's whole gradient clipped to global L2, Gaussian noise per
leaf), the pairwise secure mask, DSC, the wire with the failure-weighted
receive (dead aggregators, dead links) or the arrival weights, Eq. 4,
the FedBuff buffer fold and its cadence gate, the optimizer.  Every draw
is keyed on the replicated round key, so all ranks agree on who failed
or arrived (:func:`failure_draws`, :func:`arrival_draws`); the per-leaf
draws (:func:`ldp_noise`, :func:`mask_row`) are taken
:data:`random.CHUNK` coordinates at a time, straight into the leaf.

The reference's step is a pure function that ``jit`` may donate its
state to (``lower_train_step`` jits it with ``donate_argnums=(0, 1,
2)``).  Here the step consumes its state the same way: it writes each new
leaf of ``params_stored``, ``opt_state`` and ``dsc_ref`` into the dict its
old leaf came from, leaf by leaf, so a full-width state is never held
twice; it returns those containers.  A caller that needs the old state
passes copies.  Its arithmetic follows the reference's dtypes (JAX's
promotion, ``optim/optimizers.py``) and, where XLA fuses a multiply-add
(the DSC shift updates), its single rounding.

With ``capture_views`` the step also returns the adversary-view tap: per
aggregator, the real observed wire payload of every leaf with a scatter
dim (the dequantized int8 segments, or the ``grad_dtype`` rows), with a
dropped client's row and the rows of dead links and a dead aggregator
zeroed.  The f32 or bf16 wire's reduce-scatter then lowers to its
scatter half (an all-to-all of the segments) and the aggregator reduces
the rows it received, in the reference's order.

The model axis (``make_host_mesh(data, model)``): the parameters enter
TP-sharded under the family's shard plan (``models/shard_plan``), and
each model position runs the FSA step over its data group on its
TP-local leaves (the wire, the int8 codes and the DSC shifts all take
TP-local shapes; the store layout is the composite of
``dist/sharding.composite_store_shard``).  The gradient is
``loss_fn(..., tp=...)`` through the conjugate collectives, its
``partial`` leaves all-reduced over the model group
(``sharding.tp_grad_sync``).  Where no plan applies, the model axis is
data parallelism inside the client group (``pmean`` over it) when the
batch divides ``n_client * model``, else each model position repeats the
group's step.  The grad norm sums each leaf once: TP-sharded leaves over
the model group, replicated ones not.  With ``capture_views`` each
aggregator's views are its TP-local segments concatenated over the model
group.

The pipe axis (``make_host_mesh(data, model, pipe)``): the block leaves
enter cut to this rank's stage's rows, pipe major in the composite store
layout, and the gradient is ``transformer.pipeline_loss_fn`` over the
stage ring (the reference's 1F1B wavefront of ``microbatches``
slices), its model-axis partials summed first, then its pipe-replicated
leaves over the pipe group (``sharding.pipe_grad_sync``); the loss is the
same on every stage and averaged over the data group only.  The grad norm
buckets each leaf by the axes it is split over, (model?, pipe?), and sums
each bucket over those groups, so a leaf replicated over pipe counts
once.  Adam's state, the DSC shifts and the FedBuff buffer mirror the
store pieces, so they follow the cut.  Without a pipe axis
``microbatches`` is ignored, as the reference's inactive plan ignores
it.  :func:`lower_train_step` makes the step on the meta device for the
dry run's account (``launch/dryrun.py``).

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --smoke --steps 4 [--dsc] [--int8-wire] \\
        [--model-axis 2] [--pp 2 --microbatches 2] [--save DIR]
    python -m repro_torch.launch.train --arch eris-gptneo-1.3b --steps 3 \\
        --dsc --int8-wire
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.core import baselines as bl
from repro_torch.core import secure_agg as sa
from repro_torch.core.compressors import RandP, scale_by_reciprocal
from repro_torch.core.dsc import fma_shift
from repro_torch.core.eris import ROLE_SALTS
from repro_torch.core.fsa import mean_rows as _mean_rows
from repro_torch.core.pipeline import (ARRIVAL_SALT, PAIRWISE_SALT,
                                       ArrivalModel, CohortSample,
                                       DSCCompress, split_round_keys)
from repro_torch.core.settings import AsyncSettings, resolve_async
from repro_torch.dist import collectives as cl
from repro_torch.dist import sharding as sh
from repro_torch.kernels import dsc_quantize as dq_kernel
from repro_torch.kernels import quantize as q_kernel
from repro_torch.kernels.ref import fma_f32
from repro_torch.models import shard_plan as sp
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer

WIRE_SALT = 0x3177          # the int8 wire's seeds: fold_in(key, salt + i)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    grad_dtype: str = "bfloat16"     # wire dtype for the un-quantized path
    int8_wire: bool = False          # int8 blocks + f32 scales on the mesh
    use_dsc: bool = False            # client-side shifted rand-p compression
    dsc_p: float = 0.1
    dsc_gamma: float = 0.5
    fused_wire: bool = True          # int8+DSC leaves through the one-pass
                                     # dsc_quantize kernel
    shift_dtype: str = "float32"     # DSC shift-state residency
    microbatches: int = 1            # 1F1B microbatches on a pipe axis
                                     # (m + p - 1 wavefront ticks; the
                                     # bubble (p - 1) / (m + p - 1))
    remat: bool = True               # read by nothing, as the reference's
                                     # (its train.py:92): the step's loss
                                     # rematerializes under
                                     # cfg.remat_policy
    fsa: bool = True                 # False => FedAvg all-reduce baseline
    capture_views: bool = False      # adversary-view tap: per aggregator,
                                     # the observed wire payload (the
                                     # dequantized int8 segments or the
                                     # grad_dtype rows) as a step output
    # ---- FedBuff-style buffered async aggregation: arrivals fold
    # staleness-weighted updates into a per-segment buffer riding the DSC
    # state tree; params and optimizer apply every buffer_cadence rounds.
    # The flat fields are the deprecated spelling of
    # core.settings.AsyncSettings; a knob set in both places to different
    # values raises naming the field.
    async_buffer: bool = False
    buffer_cadence: int = 1
    staleness_alpha: float = 1.0
    delay_max: int = 0
    client_dropout: float = 0.0
    async_: Optional[AsyncSettings] = None
    # ---- composed-defense / failure knobs (the rounds.scenarios matrix
    # on the mesh wire)
    ldp_eps: float = 0.0             # >0: per-client L2 clip + Gaussian
    ldp_delta: float = 1e-5          # noise before transmission
    ldp_clip: float = 1.0
    secure_mask: bool = False        # Bonawitz pairwise wire masking
    agg_dropout: float = 0.0         # aggregator dropout (Appendix F.5)
    link_failure: float = 0.0        # client->aggregator link failure

    def async_settings(self) -> AsyncSettings:
        """The resolved async-runtime knobs (shared with FLConfig)."""
        return resolve_async("TrainSettings", self.async_, self)

    def arrival_model(self) -> ArrivalModel:
        return self.async_settings().arrival_model()

    def ldp_config(self) -> Optional[bl.LDPConfig]:
        if self.ldp_eps <= 0:
            return None
        return bl.LDPConfig(eps=self.ldp_eps, delta=self.ldp_delta,
                            clip=self.ldp_clip)


def dsc_stage(settings: TrainSettings) -> DSCCompress:
    """The simulator's DSC compression stage, shared verbatim by the
    distributed step (one DSC implementation, zero drift)."""
    return DSCCompress(compressor=RandP(p=settings.dsc_p),
                       gamma=settings.dsc_gamma)


def cohort_batch(batch, key: torch.Tensor, population: int, n_client: int):
    """Population-scale cohort selection for the distributed step: the
    keyed :class:`CohortSample` draw the simulator runs inside its
    rounds, applied to population-leading batch arrays, so the step's
    client-axis rows are the drawn cohort.  Returns ``(cohort_ids,
    gathered_batch)``."""
    cs = CohortSample(population=population, cohort=n_client)
    return cs.gather(split_round_keys(key), batch)


def lower_train_step(cfg: ModelConfig, mesh, shape_name: str = "train_4k",
                     settings: TrainSettings = TrainSettings(),
                     opt: Optional[Optimizer] = None):
    """This rank's train step for (cfg, mesh, shape) on the meta device,
    and its inputs: the port's counterpart of the reference's
    ``jit(...).lower()``, run under ``launch.accounting.Account`` by the
    dry run (``launch/dryrun.py``).  Returns ``(step, (params_stored,
    opt_state, dsc_ref, batch, key))``: the state is
    :func:`abstract_train_state`'s, the batch ``shapes.input_specs``' (the
    global batch, meta), and the key a uint32 (2,) host key (the port's
    keys live on the host, where the step folds them).  ``opt`` defaults
    to the reference's ``adam(3e-4)``."""
    from repro_torch.launch import shapes as shp
    from repro_torch.optim import adam
    if shp.SHAPES[shape_name].kind != "train":
        raise ValueError(f"lower_train_step: {shape_name} is a serving "
                         f"shape, not a training one")
    opt = opt or adam(3e-4)
    step = make_train_step(cfg, mesh, opt, settings, device="meta")
    params, opt_state, dsc_ref = abstract_train_state(cfg, mesh, opt,
                                                      settings)
    batch = shp.input_specs(cfg, shape_name)
    key = torch.zeros((2,), dtype=torch.uint32)
    return step, (params, opt_state, dsc_ref, batch, key)


def _validate(settings: TrainSettings, cfg: Optional[ModelConfig] = None,
              mesh=None) -> AsyncSettings:
    """The reference's validation errors in its order, word for word.
    Returns the resolved async settings."""
    if settings.async_buffer and settings.use_dsc:
        raise ValueError(
            "async_buffer does not compose with use_dsc: the Eq. 4 shift "
            "state tracks per-round aggregator receipts, which a cadence-"
            "delayed buffered apply breaks (int8_wire is the stateless "
            "wire format that does compose)")
    # one validation surface for the async knobs (shared with FLConfig):
    # raises naming the offending or conflicting field
    async_cfg = settings.async_settings()
    model_size = sh.axis_size(mesh, "model")
    pipe_size = sh.axis_size(mesh, "pipe")
    use_tp = cfg is not None and tr.tp_plan(cfg, model_size).active
    use_pipe = cfg is not None and sp.build_pipeline_plan(
        cfg, pipe_size, settings.microbatches).active
    if pipe_size > 1 and not use_pipe:
        raise ValueError(
            f"mesh has a pipe axis of size {pipe_size} but no pipeline "
            f"plan applies to family={cfg.family!r} with "
            f"n_layers={cfg.n_layers} (layers must split into equal "
            f"contiguous stages) — drop the pipe axis or pick a "
            f"divisible stage count")
    if settings.capture_views and pipe_size > 1:
        raise ValueError(
            "capture_views does not compose with a pipe axis yet: the "
            "adversary-view tap concatenates wire segments over 'model' "
            "only, so stage-sliced block leaves would alias")
    ldp = settings.ldp_config()
    failures = settings.agg_dropout > 0 or settings.link_failure > 0
    if (ldp is not None or settings.secure_mask or failures) \
            and not settings.fsa:
        raise ValueError(
            "ldp/secure_mask/agg_dropout/link_failure are FSA wire "
            "compositions; fsa=False has no per-aggregator wire to "
            "defend or fail")
    if (ldp is not None or settings.secure_mask) and (use_tp or use_pipe):
        raise ValueError(
            "ldp/secure_mask need each client's FULL local gradient "
            "(global-L2 clip / whole-leaf mask rows); run them on a "
            "client-axes-only mesh (model=pipe=1)")
    if settings.secure_mask:
        if settings.use_dsc or settings.int8_wire:
            raise ValueError(
                "secure_mask composes with the plain f32 wire only: DSC "
                "shifts and int8 quantization transform each client's "
                "payload independently, so the pairwise masks would no "
                "longer cancel in the cross-client sum")
        if settings.grad_dtype != "float32":
            raise ValueError(
                "secure_mask needs grad_dtype='float32': the fixed-point "
                "pairwise masks cancel exactly in f32 partial sums; a "
                "bf16 wire would round them into O(1) noise")
        if failures or async_cfg.arrival_model().dropout > 0:
            raise ValueError(
                "secure_mask cannot compose with failures/client dropout: "
                "pairwise masks cancel only in the full-cohort sum (the "
                "simplified protocol has no dropout-recovery round)")
    if failures and settings.async_buffer:
        raise ValueError(
            "agg_dropout/link_failure compose with the synchronous FSA "
            "step; the async buffered runtime models client dropout "
            "through its ArrivalModel instead")
    if settings.grad_dtype not in sh.FLOAT_DTYPES:
        raise ValueError(f"grad_dtype must be one of "
                         f"{sorted(sh.FLOAT_DTYPES)}, got "
                         f"{settings.grad_dtype!r}")
    sh.shift_state_dtype(settings.shift_dtype)
    return async_cfg


# ------------------------------------------------------------ state trees
def _scatter_dims(cfg: ModelConfig, mesh, settings: TrainSettings) -> dict:
    """Each leaf's scatter dim under FSA; -1 everywhere without it (the
    FedAvg baseline keeps every leaf whole)."""
    dims = sh.fsa_scatter_dims(cfg, mesh)
    return dims if settings.fsa else tree_map(lambda d: -1, dims)


def store_cuts(cfg: ModelConfig, mesh,
               settings: TrainSettings = TrainSettings()) -> list:
    """Each leaf's chain of cuts to this rank's store piece, in flatten
    order (``sharding.composite_box``): its stage's rows on the pipe axis,
    its model position's TP shard, then its aggregator's segment at the
    scatter dim (none with ``fsa=False``), each ``(dim, parts, index)``."""
    n_client, aidx = sh.client_count(mesh), sh.client_rank(mesh)
    tp, midx = sh.axis_size(mesh, "model"), sh.axis_rank(mesh, "model")
    pp, pidx = sh.axis_size(mesh, "pipe"), sh.axis_rank(mesh, "pipe")
    return [((pd, pp, pidx), (s.dim, tp, midx), (d, n_client, aidx))
            for pd, s, d in zip(tree_leaves(sh.pipe_dims(cfg, pp)),
                                tree_leaves(sh.tp_specs(cfg, tp)),
                                tree_leaves(_scatter_dims(cfg, mesh,
                                                          settings)))]


def store_params(params: dict, cfg: ModelConfig, mesh,
                 settings: TrainSettings = TrainSettings()) -> dict:
    """This rank's ``params_stored``: each leaf of the full ``params`` cut
    to its stage's rows and its model position's TP shard, then to this
    aggregator's store segment of that under FSA (whole where the scatter
    dim is -1, and everywhere with ``fsa=False``).  The pieces are copies,
    so the full tree can be freed."""
    return tree_unflatten(params, [
        sh.cut_piece(x, cuts).clone()
        if any(d >= 0 and n > 1 for d, n, _ in cuts) else x
        for x, cuts in zip(tree_leaves(params),
                           store_cuts(cfg, mesh, settings))])


def abstract_train_state(cfg: ModelConfig, mesh, opt: Optimizer,
                         settings: TrainSettings = TrainSettings()):
    """Meta tensors (shape and dtype, no storage) of this rank's
    ``(params_stored, opt_state, dsc_ref)``: the reference's
    ``ShapeDtypeStruct``s cut to one position (store shards of the pipe-
    and TP-local leaves; adam's step count and the buffer's w and t
    replicated)."""
    n_client = sh.client_count(mesh)
    dtype = sh.FLOAT_DTYPES[cfg.dtype]
    dims = _scatter_dims(cfg, mesh, settings)
    full = sh.local_shape_tree(cfg, mesh, lambda shape: torch.empty(
        shape, dtype=dtype, device="meta"))
    params = tree_map(
        lambda x, d: sh.store_shard(x, d, n_client, 0), full, dims)
    return params, opt.init(params), _dsc_tree(full, params, settings,
                                               "meta")


def _dsc_tree(full: dict, stored: dict, settings: TrainSettings, device):
    """This rank's DSC state: its own client shift s_k (a ``(1, *shape)``
    block of the client-stacked global, pipe- and TP-local leaf shapes)
    and s_agg on its own store segments; without DSC a tree of f32 scalar
    placeholders.
    With ``async_buffer`` that tree is ``{"dsc": ..., "buffer": {"u", "w",
    "t"}}``: the FedBuff accumulator u, f32 in the store layout (each rank
    buffers its own segments), and the replicated weight w (f32) and round
    count t (int32), kept on the host as adam's step count is (the step
    reads t to decide its cadence)."""
    if not settings.use_dsc:
        tree = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                              device=device), full)
    else:
        sdt = sh.shift_state_dtype(settings.shift_dtype)
        tree = {"s_clients": tree_map(lambda p: torch.zeros(
                    (1, *p.shape), dtype=sdt, device=device), full),
                "s_agg": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=sdt, device=device), stored)}
    if not settings.async_buffer:
        return tree
    return {"dsc": tree, "buffer": {
        "u": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=device), stored),
        "w": torch.zeros((), dtype=torch.float32),
        "t": torch.zeros((), dtype=torch.int32)}}


def init_dsc_state(cfg: ModelConfig, mesh, settings: TrainSettings,
                   device: DeviceLike = None):
    """This rank's zero DSC shift state, and the empty FedBuff buffer with
    ``async_buffer`` (see :func:`_dsc_tree`), on ``device`` (the CUDA card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    n_client = sh.client_count(mesh)
    aidx = sh.client_rank(mesh)
    dims = _scatter_dims(cfg, mesh, settings)
    full = sh.local_shape_tree(cfg, mesh, lambda shape: torch.empty(
        shape, device="meta"))
    stored = tree_map(lambda x, d: sh.store_shard(x, d, n_client, aidx),
                      full, dims)
    return _dsc_tree(full, stored, settings, device)


# ------------------------------------------------------ the round's draws
# Each is a function of the replicated round key, so that every rank draws
# the same failures and arrivals; the per-leaf draws fold the leaf index
# (and the rank where each client draws its own).
def failure_draws(key: torch.Tensor, n_client: int, agg_dropout: float,
                  link_failure: float):
    """Appendix F.5 on the mesh: ``(agg_alive (n,), link_alive (n, n)
    [client k, aggregator a], link_cnt (n,))``, f32 on the host, from
    ``split(fold_in(key, ROLE_SALTS["fail"]))``.  A dead link zeroes
    client k's share of aggregator a's segment, which renormalizes by its
    live-receipt count ``max(sum_k link_alive[k, a], 1)``."""
    ka, kl = random.split(random.fold_in(key, ROLE_SALTS["fail"]))
    agg_alive = random.bernoulli(ka, 1.0 - agg_dropout, (n_client,)).float()
    link_alive = random.bernoulli(kl, 1.0 - link_failure,
                                  (n_client, n_client)).float()
    return agg_alive, link_alive, torch.clamp(link_alive.sum(0), min=1.0)


def arrival_draws(key: torch.Tensor, n_client: int, arrival: ArrivalModel):
    """The async arrivals: ``(tau, alive, omega, w_round)`` on the host,
    the simulator's ``ArrivalModel`` draw on ``fold_in(key,
    ARRIVAL_SALT)`` (no rank fold: every rank must agree on who arrived),
    and the round's arrival mass ``omega.mean()`` (XLA's CPU mean)."""
    tau, alive, omega = arrival.draw(random.fold_in(key, ARRIVAL_SALT),
                                     n_client)
    return tau, alive, omega, _mean_rows(omega)


def ldp_noise(key: torch.Tensor, i: int, aidx: int, shape: tuple, *,
              device=None, window: Optional[tuple] = None) -> torch.Tensor:
    """Rank ``aidx``'s Gaussian noise for leaf ``i``: ``normal(fold_in(
    fold_in(key, ROLE_SALTS["noise"] + i), aidx), shape)``, f32, the
    flat elements [lo, hi) with a ``window``."""
    k = random.fold_in(random.fold_in(key, ROLE_SALTS["noise"] + i), aidx)
    return random.normal(k, shape, device=device, window=window)


def mask_row(key: torch.Tensor, i: int, aidx: int, n_client: int, n: int, *,
             device=None, window: Optional[tuple] = None) -> torch.Tensor:
    """Rank ``aidx``'s pairwise secure mask for leaf ``i`` of ``n``
    elements: its row of the fixed-point grid keyed on ``fold_in(fold_in(
    key, PAIRWISE_SALT), i)``; the rows of all ranks sum to exactly zero.
    f32, the flat elements [lo, hi) with a ``window``."""
    k = random.fold_in(random.fold_in(key, PAIRWISE_SALT), i)
    return sa.pairwise_mask_row(k, aidx, n_client, n, device=device,
                                window=window)


def _weighted_rows(w: list, rows: torch.Tensor) -> torch.Tensor:
    """``einsum("k,km->m", w, rows)`` for f32 weights, as XLA's CPU
    compiler computes it: a chain of f32 fused multiply-adds over k, from
    zero.  Rows of a 16-bit wire are widened to f32 and the sum rounded
    once to their dtype (weights rounded to it first, as the reference's
    ``astype(rx.dtype)``)."""
    if rows.dtype != torch.float32:
        w = [float(torch.tensor(x, dtype=rows.dtype)) for x in w]
        return _weighted_rows(w, rows.float()).to(rows.dtype)
    acc = rows[0] * w[0]
    for k in range(1, len(w)):
        acc = fma_shift(w[k], rows[k], acc)
    return acc


def _reduce_rows(rows: torch.Tensor, rx_w: Optional[list] = None,
                 omega: Optional[list] = None) -> torch.Tensor:
    """An aggregator's reduction of the (n_client, m) rows it received:
    their mean (the rows summed in order times the f32 reciprocal of
    their count; a 16-bit wire summed in f32, as ``jnp.mean`` upcasts);
    with ``rx_w`` the failure-weighted sum; with ``omega`` the
    arrival-weighted sum over n_client."""
    n = rows.shape[0]
    if rx_w is not None:
        return _weighted_rows(rx_w, rows)
    if omega is not None:
        return scale_by_reciprocal(_weighted_rows(omega, rows), n)
    if rows.dtype != torch.float32:
        return _mean_rows(rows.float()).to(rows.dtype)
    return _mean_rows(rows)


def _tapped_rows(rx: torch.Tensor, w: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Received rows as the view tap captures them: each row times its
    0/1 weight (None keeps them all), f32, under a leading (1, ...)
    aggregator axis."""
    if w is not None:
        rx = rx * w.to(rx.device, rx.dtype)[:, None]
    return rx.float()[None]


# ------------------------------------------------------- tree plumbing
def _slots(tree) -> list:
    """Where each leaf of a nested dict lives, as ``(dict, key)``, in
    flatten order: the step reads a leaf there and writes its successor
    in its place."""
    return [s for key in sorted(tree) for s in
            (_slots(tree[key]) if isinstance(tree[key], dict)
             else [(tree, key)])]


def _map_parts(fn, state):
    """``state`` with ``fn`` applied to each of its dicts: the parts that
    mirror the parameters (momentum's buffer, adam's mu and nu are the
    only dicts the port's optimizers keep); tuples rebuilt, scalars
    (adam's t) kept."""
    if isinstance(state, dict):
        return fn(state)
    if isinstance(state, tuple):
        kids = [_map_parts(fn, c) for c in state]
        return (type(state)(*kids) if hasattr(state, "_fields")
                else tuple(kids))
    return state


# ------------------------------------------------------------ the wire
def _padded_rows(x: torch.Tensor, dim: int, n_client: int,
                 lay: sh.WireLayout) -> torch.Tensor:
    """The leaf's FSA segments as f32 rows padded to the wire layout:
    a contiguous ``(n_client, padded_elems)`` tensor."""
    rows = sh.split_shards(x.float(), dim, n_client)
    m, mp = lay.shard_elems, lay.padded_elems
    if mp == m:
        return rows.contiguous()
    out = x.new_zeros((n_client, mp), dtype=torch.float32)
    out[:, :m] = rows
    return out


def int8_payload(v: torch.Tensor, dim: int, n_client: int, seed: int):
    """What one client sends of a leaf on the int8 wire: its n_client
    segments, f32, padded to the wire layout and quantized in ONE call
    over the ``(n_client, padded)`` block, so the draws are keyed from
    index 0 across the rows as the reference's are.  Returns (codes int8
    (n_client, padded), scales f32 (n_client, n_blocks))."""
    lay = sh.wire_layout_for(tuple(v.shape), n_client)
    rows = _padded_rows(v, dim, n_client, lay)
    q, scale = q_kernel.quantize(rows.view(-1), seed, index_base=0)
    return q.view(n_client, -1), scale.view(n_client, -1)


def fused_payload(g: torch.Tensor, s: torch.Tensor, dim: int, n_client: int,
                  seed_mask: int, seed_round: int, p: float, gamma: float):
    """The int8+DSC payload of a leaf through the ``dsc_quantize`` kernel:
    mask draw, shift subtract, quantize and shift update over the padded
    segments of g and s in one pass.  Returns (codes, scales, as
    :func:`int8_payload`; s' in s's shape and dtype).  s' is computed in
    the f32 rows of s, which are s itself where the layout allows: the
    step consumes its shift state."""
    lay = sh.wire_layout_for(tuple(g.shape), n_client)
    g_rows = _padded_rows(g, dim, n_client, lay)
    s_rows = _padded_rows(s, dim, n_client, lay)
    q, scale, _ = dq_kernel.dsc_quantize(
        g_rows.view(-1), s_rows.view(-1), seed_mask, seed_round, p=p,
        gamma=gamma, out=s_rows.view(-1))
    del g_rows
    s_new = sh.merge_shards(s_rows[:, :lay.shard_elems], dim,
                            tuple(g.shape), n_client).to(s.dtype)
    return q.view(n_client, -1), scale.view(n_client, -1), s_new


class _Wire:
    """The collectives of one step over the mesh's client group, the
    ``"data"`` axis's or, on the multi-pod mesh, the flattened ``("pod",
    "data")`` group of ``sharding.client_group`` (``dist.collectives``:
    the list forms of all-gather and reduce-scatter, which both torch
    versions the port runs on have, where torch 2.13 deprecates
    ``reduce_scatter_tensor`` and ``all_gather_into_tensor``; through host
    buffers on a gloo group of the card)."""

    def __init__(self, mesh):
        self.group = sh.client_group(mesh)
        self.n = sh.client_count(mesh)
        self.aidx = dist.get_rank(self.group)

    def gather(self, shard: torch.Tensor, dim: int,
               shape: tuple) -> torch.Tensor:
        """The FSA broadcast of one leaf: every rank's store shard,
        merged into the full leaf."""
        if dim < 0:
            return shard
        rows = cl.all_gather(shard.reshape(1, -1), self.group, 0)
        return sh.merge_shards(rows, dim, shape, self.n)

    def reduce_scatter(self, g: torch.Tensor, dim: int,
                       row_w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``psum_scatter(g, scatter_dimension=dim, tiled=True)``; with
        ``row_w`` (n,) in g's dtype, segment a is scaled by ``row_w[a]``
        before the collective (the failure-injected reduce-scatter)."""
        rows = sh.split_shards(g, dim, self.n)
        rows = (rows * row_w.to(rows.device)[:, None] if row_w is not None
                else rows.contiguous())
        out = cl.reduce_scatter(rows, self.group, 0)
        shape = list(g.shape)
        shape[dim] //= self.n
        return out.view(shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return cl.all_reduce(x, self.group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Row a of every rank to rank a (``all_to_all(x, 0, 0,
        tiled=True)``)."""
        return cl.all_to_all(x, self.group)

    def int8_exchange(self, v: torch.Tensor, dim: int, seed: int,
                      need_round_trip: bool, rx_w: Optional[list] = None,
                      omega: Optional[list] = None):
        """The int8 reduce-scatter of one leaf (the reference's
        ``_int8_wire_exchange``): :func:`int8_payload`, codes and scales
        exchanged, what arrives dequantized and reduced (:meth:`_receive`).
        Returns (my segment's reduction, f32, in the store shard's shape;
        the full leaf's local round trip or None; the (n_client, m)
        dequantized rows received, the adversary's view of the leaf)."""
        n = self.n
        lay = sh.wire_layout_for(tuple(v.shape), n)
        q, scale = int8_payload(v, dim, n, seed)
        v_hat = None
        if need_round_trip:
            v_hat = sh.merge_shards(
                q_kernel.dequantize(q.view(-1), scale.view(-1))
                .view(n, -1)[:, :lay.shard_elems], dim, tuple(v.shape), n)
        my, rx = self._receive(q, scale, lay, dim, tuple(v.shape), rx_w,
                               omega)
        return my, v_hat, rx

    def fused_exchange(self, g: torch.Tensor, s: torch.Tensor, dim: int,
                       seed_mask: int, seed_round: int, p: float,
                       gamma: float, rx_w: Optional[list] = None):
        """The int8+DSC wire of one leaf (the reference's
        ``_fused_wire_exchange``): :func:`fused_payload`, then the
        exchange.  Returns (my segment's reduction, s_new in s's dtype,
        the dequantized rows received)."""
        lay = sh.wire_layout_for(tuple(g.shape), self.n)
        q, scale, s_new = fused_payload(g, s, dim, self.n, seed_mask,
                                        seed_round, p, gamma)
        my, rx = self._receive(q, scale, lay, dim, tuple(g.shape), rx_w)
        return my, s_new, rx

    def scatter_exchange(self, g: torch.Tensor, dim: int,
                         rx_w: Optional[list] = None,
                         omega: Optional[list] = None):
        """The reduce-scatter of one leaf in its own dtype lowered to its
        scatter half, for the view tap: its segments to their aggregators
        (an all-to-all), and the aggregator's reduction of the rows it
        received (:func:`_reduce_rows`).  Returns (my segment's reduction
        in the store shard's shape, the rows received)."""
        rx = self.all_to_all(sh.split_shards(g, dim, self.n))
        shape = list(g.shape)
        shape[dim] //= self.n
        return _reduce_rows(rx, rx_w, omega).view(shape), rx

    def _receive(self, q, scale, lay, dim, shape, rx_w=None, omega=None):
        """The exchange and the aggregator's reduction of the rows it
        receives (:func:`_reduce_rows`: their mean; with ``rx_w`` the
        failure-weighted sum, live links renormalized by their count, zero
        at a dead aggregator; with ``omega`` the arrival-weighted sum over
        n_client).  Returns (the reduction in the store shard's shape, the
        (n_client, m) dequantized rows, a view of the received block)."""
        n, m, mp = self.n, lay.shard_elems, lay.padded_elems
        q_rx = self.all_to_all(q)
        s_rx = self.all_to_all(scale)
        del q, scale
        rx = q_kernel.dequantize(q_rx.view(-1), s_rx.view(-1)).view(n, mp)
        shard_shape = list(shape)
        shard_shape[dim] //= n
        return _reduce_rows(rx[:, :m], rx_w, omega).view(shard_shape), \
            rx[:, :m]


# ------------------------------------------------------------- the step
def make_train_step(cfg: ModelConfig, mesh, opt: Optimizer,
                    settings: TrainSettings = TrainSettings(),
                    device: DeviceLike = None,
                    mark: Optional[Callable[[str], None]] = None):
    """Returns ``step(params_stored, opt_state, dsc_ref, batch, key)`` ->
    ``(params_stored, opt_state, dsc_ref, {"loss", "grad_norm"})`` on this
    rank's pieces (see the module docstring for what it consumes):

    * ``params_stored``: this rank's store shards (:func:`store_params`);
    * ``opt_state``: ``opt.init(params_stored)``, mirroring it leaf for
      leaf (scalars replicated);
    * ``dsc_ref``: :func:`init_dsc_state`'s tree (with ``async_buffer``,
      the DSC tree and the FedBuff buffer);
    * ``batch``: the GLOBAL batch; the step takes rows
      [a B / n, (a + 1) B / n) of each leaf, as ``P(caxis)`` does;
    * ``key``: the round key (``repro_torch.random``), replicated.

    With ``capture_views`` (and FSA) the step returns a fifth element,
    the adversary-view tap: ``{str(i): (1, n_client, m)}`` f32 for every
    leaf i with a scatter dim, the rows of leaf i's segment that this
    aggregator received, one per client (the reference's per-aggregator
    block of its ``(A, K, m)`` view); on a model axis m is the TP-local
    segments of the model group's ranks concatenated in rank order (every
    rank of the group returns the same).

    On a (data, pipe, model) mesh every piece above is pipe- and
    TP-local: this rank's stage's rows of its model position's shard, cut
    as :func:`store_params` cuts it.  The batch is the client group's
    whole: the pipelined loss slices it into ``settings.microbatches``.

    The tensors live on ``device``, the CUDA card unless the caller asks
    for the CPU.  ``mark(name)``, when given, is called as each part of
    the step begins ("gather", "gradient", "ldp" with LDP on, "wire",
    "optimizer") and with "end" after the last: a hook for timing."""
    if cfg.attn_batch_shard:
        cfg = dataclasses.replace(cfg, attn_batch_shard=False)
    async_cfg = _validate(settings, cfg, mesh)
    capture = settings.capture_views and settings.fsa
    device = resolve_device(device)
    wire = _Wire(mesh)
    n_client, aidx = wire.n, wire.aidx
    model_size = sh.axis_size(mesh, "model")
    plan = tr.tp_plan(cfg, model_size)
    use_tp = plan.active
    mgroup = mesh.get_group("model") if model_size > 1 else None
    midx = sh.axis_rank(mesh, "model")
    tp_rt = tr.TPRuntime(mgroup, model_size, midx, plan) if use_tp else None
    pipe_size = sh.axis_size(mesh, "pipe")
    pplan = sp.build_pipeline_plan(cfg, pipe_size, settings.microbatches)
    pipe_rt = (sp.PipeRuntime(mesh.get_group("pipe"), pipe_size,
                              sh.axis_rank(mesh, "pipe"), pplan)
               if pplan.active else None)
    specs = tree_leaves(sh.tp_specs(cfg, model_size))
    pdims = tree_leaves(sh.pipe_dims(cfg, pipe_size))
    dims = tree_leaves(_scatter_dims(cfg, mesh, settings))
    shapes = sh.local_shapes(cfg, mesh)
    grad_dtype = sh.FLOAT_DTYPES[settings.grad_dtype]
    stage = dsc_stage(settings) if settings.use_dsc else None
    note = mark or (lambda name: None)
    ldp = settings.ldp_config()
    sigma = (float(np.float32(bl.gaussian_sigma(ldp.eps, ldp.delta,
                                                ldp.clip)))
             if ldp is not None else None)
    failures = settings.agg_dropout > 0 or settings.link_failure > 0
    arrival = async_cfg.arrival_model()

    def wire_seed(key, i: int) -> int:
        k = random.fold_in(random.fold_in(key, WIRE_SALT + i), aidx)
        return int(random.bits(k))

    def model_split(batch: dict) -> bool:
        """Without a plan the model axis splits the group's batch when
        the global batch divides all mesh positions (``P((data,
        model))``), else every model position repeats its group's."""
        rows = next(iter(torch.as_tensor(x).shape[0]
                         for x in batch.values()
                         if torch.as_tensor(x).dim() > 0))
        return (not use_tp and pipe_rt is None and model_size > 1
                and rows % (n_client * model_size) == 0)

    def local_batch(batch: dict, split: bool) -> dict:
        blocks = n_client * model_size if split else n_client
        blk = aidx * model_size + midx if split else aidx
        out = {}
        for name, x in batch.items():
            x = torch.as_tensor(x).to(device)
            if x.dim() == 0:
                out[name] = x
                continue
            if x.shape[0] % blocks:
                raise ValueError(
                    f"batch[{name!r}] has {x.shape[0]} rows, which the "
                    f"{n_client} client groups cannot share equally")
            b = x.shape[0] // blocks
            out[name] = x[blk * b:(blk + 1) * b]
        return out

    def clip_scale(grads: list) -> float:
        """LDP's clip factor of this rank's whole gradient: ``minimum(1,
        clip / maximum(sqrt(sum_i sum(g_i ** 2)), 1e-12))`` in f32, each
        leaf's sum in XLA's CPU order (``random.reduce_sum``), the leaves
        added in order."""
        gn2 = torch.zeros((), dtype=torch.float32, device=device)
        for g in grads:
            gn2 = gn2 + random.reduce_sum(torch.square(g.float()).view(-1))
        if gn2.is_meta:
            return 1.0      # the dry run: no values; the ops are the same
        gn = np.maximum(np.sqrt(np.float32(float(gn2))), np.float32(1e-12))
        return float(np.minimum(np.float32(1.0), np.float32(ldp.clip) / gn))

    def perturb_leaf(g: torch.Tensor, i: int, key,
                     clip_s: float) -> torch.Tensor:
        """LDP on leaf i, in place where g is contiguous: ``g * clip_s +
        sigma * noise`` in f32 (one FMA, as XLA compiles it), rounded to
        g's dtype."""
        g = g.contiguous()
        flat = g.view(-1)
        for lo in range(0, flat.numel(), random.CHUNK):
            hi = min(flat.numel(), lo + random.CHUNK)
            noise = ldp_noise(key, i, aidx, tuple(g.shape), device=g.device,
                              window=(lo, hi)).mul_(sigma)
            flat[lo:hi] = fma_f32(clip_s, flat[lo:hi].float(),
                                  noise).to(g.dtype)
            del noise
        return g

    def mask_leaf(g: torch.Tensor, i: int, key) -> torch.Tensor:
        """The secure mask on leaf i, in place where g is contiguous: this
        rank's row, cast to g's dtype, added (so a 16-bit leaf's rows no
        longer cancel)."""
        g = g.contiguous()
        flat = g.view(-1)
        for lo in range(0, flat.numel(), random.CHUNK):
            hi = min(flat.numel(), lo + random.CHUNK)
            flat[lo:hi] += mask_row(key, i, aidx, n_client, flat.numel(),
                                    device=g.device,
                                    window=(lo, hi)).to(g.dtype)
        return g

    def tap_weights(fail, alive):
        """The view tap's row weights (None keeps every row): ``fail_w``
        zeroes the rows that never arrived (dead links into this
        aggregator, every row at a dead aggregator), ``drop_w`` a dropped
        client's row too (it sent nothing)."""
        fail_w = (None if fail is None
                  else fail[1][:, aidx] * fail[0][aidx])
        if alive is None:
            return fail_w, fail_w
        drop_w = alive.float()
        return fail_w, drop_w if fail_w is None else fail_w * drop_w

    def aggregate_leaf(i: int, g, dim: int, s_slot, key, fail, rx_w, omega,
                       views: Optional[dict] = None, row_w=(None, None)):
        """Leaf i's compression and exchange (the reference's loop body,
        :523-634): this aggregator's reduction of its segment, or of the
        whole leaf where it has no scatter dim.  Writes client shift s_k's
        new leaf into its slot ``s_slot`` of ``dsc_ref``; with ``views``
        (the tap) the rows this aggregator received into
        ``views[str(i)]``, weighed by ``row_w`` (:func:`tap_weights`: the
        DSC wires, where no client drops, by ``fail_w``)."""
        int8 = settings.int8_wire and settings.fsa and dim >= 0
        tapped = views is not None and dim >= 0
        fail_w, drop_w = row_w
        if settings.secure_mask:
            g = mask_leaf(g, i, key)
        if stage is not None:
            k = random.fold_in(random.fold_in(key, i), aidx)
            box, name = s_slot
            s = box[name][0]
            if int8 and settings.fused_wire:
                agg, s_new, rx = wire.fused_exchange(
                    g, s, dim, int(random.bits(k)), wire_seed(key, i),
                    settings.dsc_p, settings.dsc_gamma, rx_w=rx_w)
                box[name] = s_new[None]
                if tapped:
                    views[str(i)] = _tapped_rows(rx, fail_w)
                return agg
            if int8:
                # the wire format inside the shifted compressor: s_k tracks
                # what the aggregators actually receive
                v = stage.compressor(k, g.to(s.dtype) - s)
                agg, v_hat, rx = wire.int8_exchange(
                    v, dim, wire_seed(key, i), need_round_trip=True,
                    rx_w=rx_w)
                del v
                box[name] = fma_shift(stage.gamma, v_hat, s)[None]
                if tapped:
                    views[str(i)] = _tapped_rows(rx, fail_w)
                return agg
            v, s_new = stage.apply_leaf(k, g, s)
            box[name] = s_new[None]
            g = v.to(g.dtype)
            del v, s_new, s
        if int8:
            agg, _, rx = wire.int8_exchange(g, dim, wire_seed(key, i),
                                            need_round_trip=False,
                                            rx_w=rx_w, omega=omega)
            if tapped:
                views[str(i)] = _tapped_rows(rx, drop_w)
            return agg
        if omega is not None and not tapped:
            # each rank is one client: its arrival weight discounts its
            # own contribution before the reduce (with the tap, the
            # aggregator weighs the rows it received instead)
            g = g * torch.tensor(omega[aidx], dtype=g.dtype)
        g = g.to(grad_dtype)
        if settings.fsa and dim >= 0:
            if tapped:
                # the tap needs the per-client segments: the reduce-scatter
                # lowers to its scatter half, as on the int8 wire, and the
                # aggregator reduces what it received
                agg, rx = wire.scatter_exchange(g, dim, rx_w, omega)
                views[str(i)] = _tapped_rows(rx, drop_w)
                return agg
            if fail is not None:
                # the failure-injected reduce-scatter: segment a scaled by
                # link_alive[aidx, a] / link_cnt[a] before the collective
                # (the sum lands as the renormalized mean over live
                # receipts), then zeroed at a dead aggregator; no 1/n
                agg_alive, link_alive, link_cnt = fail
                g = wire.reduce_scatter(
                    g, dim, row_w=(link_alive[aidx] / link_cnt).to(g.dtype))
                return g * agg_alive[aidx].to(g.dtype)
            g = wire.reduce_scatter(g, dim)
        else:
            g = wire.all_reduce(g)
        return scale_by_reciprocal(g, n_client)      # jnp's g / n_client

    def fold(buf: dict, out: list, w_round) -> bool:
        """The FedBuff fold and cadence gate (the reference's :652-675):
        ``u += w_r g`` per leaf (one FMA) and ``w += w_r``; on an apply
        round (t + 1 a multiple of the cadence, decided on the host from
        t) ``out`` becomes ``u / max(w, 1e-12)`` and the buffer empties;
        otherwise ``out`` is emptied and nothing is applied.  Trivial
        arrivals and cadence 1 make this the identity (0 + 1.0 g, u /
        1.0).  Returns whether this round applies."""
        w_r = 1.0 if w_round is None else float(w_round)
        t_new = int(buf["t"]) + 1
        apply = t_new % async_cfg.buffer_cadence == 0
        w_acc = np.float32(float(buf["w"])) + np.float32(w_r)
        denom = torch.tensor(max(w_acc, np.float32(1e-12)),
                             dtype=torch.float32, device=device)
        for i, (box, name) in enumerate(_slots(buf["u"])):
            u = fma_shift(w_r, out[i].float(), box[name])
            out[i] = None
            if apply:
                out[i] = u / denom
                u.zero_()
            box[name] = u
            del u
        buf["w"] = torch.tensor(0.0 if apply else w_acc,
                                dtype=torch.float32)
        buf["t"] = torch.tensor(t_new, dtype=torch.int32)
        return apply

    def step(params_stored, opt_state, dsc_ref, batch, key):
        slots = _slots(params_stored)
        if len(slots) != len(dims):
            raise ValueError(f"params_stored has {len(slots)} leaves, the "
                             f"config {len(dims)}")
        state, buf = dsc_ref, None
        if settings.async_buffer:
            state, buf = dsc_ref["dsc"], dsc_ref["buffer"]
        # the round's draws, on the host, the same on every rank
        omega = w_round = alive = None
        if settings.async_buffer and not arrival.trivial:
            _, alive, omega_t, w_round = arrival_draws(key, n_client,
                                                       arrival)
            omega = [float(x) for x in omega_t]
        fail = rx_w = None
        if failures:
            fail = failure_draws(key, n_client, settings.agg_dropout,
                                 settings.link_failure)
            agg_alive, link_alive, link_cnt = fail
            # the failure-weighted receive: aggregator aidx weights each
            # received row by its live link, renormalized by the live
            # count, and zero everywhere when it died itself
            rx_w = [float(x) for x in link_alive[:, aidx] * agg_alive[aidx]
                    / link_cnt[aidx]]

        # 1. the FSA broadcast
        note("gather")
        leaves = [wire.gather(box[name], d, shape).detach().requires_grad_()
                  for (box, name), d, shape in zip(slots, dims, shapes)]

        # 2. this client group's gradient (on the model axis: its shard's,
        # the partial leaves summed over the model group; on the pipe
        # axis: its stage's, through the wavefront, then the pipe-
        # replicated leaves summed over the stages)
        note("gradient")
        split = model_split(batch)
        with torch.enable_grad():
            loss = tr.pipeline_loss_fn(
                tree_unflatten(params_stored, leaves), cfg,
                local_batch(batch, split), tp=tp_rt, pipe=pipe_rt)
            grads = list(torch.autograd.grad(loss, leaves))
        del leaves
        if use_tp:
            grads = sh.tp_grad_sync(grads, specs, tp_rt)
        if pipe_rt is not None:
            grads = sh.pipe_grad_sync(grads, pdims, pipe_rt)
        lsum = wire.all_reduce(loss.detach().float().reshape(1))
        if split:
            # the model axis as data parallelism inside the group: the
            # group's update is the mean over its model positions
            lsum = cl.all_reduce(lsum, mgroup)
            grads = [scale_by_reciprocal(cl.all_reduce(g, mgroup),
                                         model_size) for g in grads]
        loss_val = scale_by_reciprocal(             # pmean: psum / n
            lsum[0], n_client * (model_size if split else 1))
        del loss
        if ldp is not None:
            # LDP, client-side: the whole gradient's norm before any leaf
            # is perturbed, then each leaf clipped and noised in place
            note("ldp")
            clip_s = clip_scale(grads)
            for i in range(len(grads)):
                grads[i] = perturb_leaf(grads[i], i, key, clip_s)

        # 3-4. the defenses, compression and the FSA aggregation, leaf by
        # leaf; each gradient is dropped as soon as its segment has arrived
        note("wire")
        s_slots = (_slots(state["s_clients"]) if settings.use_dsc
                   else [None] * len(dims))
        out: list = [None] * len(grads)
        views = {} if capture else None
        row_w = tap_weights(fail, alive)
        for i, (dim, s_slot) in enumerate(zip(dims, s_slots)):
            g, grads[i] = grads[i], None
            out[i] = aggregate_leaf(i, g, dim, s_slot, key, fail, rx_w,
                                    omega, views, row_w)
            del g
        del grads
        if views and model_size > 1:
            # each aggregator's view: its model group's TP-local segments
            views = {k: cl.all_gather(v, mgroup, 2)
                     for k, v in views.items()}

        if settings.use_dsc:
            # Eq. 4 compensation on this aggregator's own segments:
            # u = s_agg + mean_k v_k;  s_agg <- s_agg + gamma (u - s_agg)
            for i, (box, name) in enumerate(_slots(state["s_agg"])):
                s = box[name]
                u = s + out[i].to(s.dtype)
                box[name] = fma_shift(settings.dsc_gamma, u - s, s)
                out[i] = u
                del s, u

        # the FedBuff buffer: a round that does not apply leaves params
        # and optimizer state as they are, bit for bit (the reference
        # computes the update and discards it)
        apply = buf is None or fold(buf, out, w_round)

        # 5. the shard-local optimizer, leaf by leaf: leaf i's state is
        # the i-th leaf of each part that mirrors the parameters, with the
        # incoming scalars (adam's t); its successors go back in place
        note("optimizer")
        sq, new_state = [], opt_state
        if apply:
            sq, new_state = _optimize(opt, slots, opt_state, out)
        del out
        gn2 = (_norm_sq(sq, specs, pdims, tp_rt, pipe_rt) if sq
               else torch.zeros((), dtype=torch.float32, device=device))
        if settings.fsa:
            gn2 = wire.all_reduce(gn2.reshape(1))[0]
        metrics = {"loss": loss_val, "grad_norm": torch.sqrt(gn2)}
        note("end")
        if capture:
            return params_stored, new_state, dsc_ref, metrics, views
        return params_stored, new_state, dsc_ref, metrics

    return step


def _norm_sq(sq: list, specs: list, pdims: list, tp, pipe) -> torch.Tensor:
    """This rank's share of the squared grad norm: the leaves' squared
    sums added in order; on a model axis (``tp``) or a pipe axis
    (``pipe``) bucketed by the axes a leaf is split over, (model?,
    pipe?), each bucket summed over the model group, then over the pipe
    group, and the bucket of leaves split over neither counted once (the
    reference's ``:704-721``, its buckets in order of first use)."""
    if tp is None and pipe is None:
        return sum(sq)
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    buckets: dict = {}
    for x, s, pd in zip(sq, specs, pdims):
        axes = ((tp is not None and s.dim >= 0),
                (pipe is not None and pd >= 0))
        buckets[axes] = buckets.get(axes, zero) + x
    gn2 = zero
    for (on_model, on_pipe), tot in buckets.items():
        if on_model:
            tot = cl.all_reduce(tot.reshape(1), tp.group)[0]
        if on_pipe:
            tot = cl.all_reduce(tot.reshape(1), pipe.group)[0]
        gn2 = gn2 + tot
    return gn2


def _optimize(opt: Optimizer, slots: list, opt_state, out: list):
    """The optimizer over the parameter leaves at ``slots``, one leaf at a
    time, each new leaf written in place (params and the state's parts).
    Returns (each update's squared f32 sum, the new state)."""
    parts = []
    _map_parts(parts.append, opt_state)
    part_slots = [_slots(part) for part in parts]
    sq, piece = [], opt_state
    for i, (box, name) in enumerate(slots):
        p = box[name]
        g, out[i] = out[i].to(p.dtype), None
        sq.append(torch.sum(torch.square(g.float())))
        cut = iter([b[k] for b, k in (ps[i] for ps in part_slots)])
        delta, piece = opt.update({"x": g}, _map_parts(
            lambda _: {"x": next(cut)}, opt_state), {"x": p})
        del g, cut
        new = []
        _map_parts(new.append, piece)
        for ps, leaf in zip(part_slots, new):
            b, k = ps[i]
            b[k] = leaf["x"]
        box[name] = p + delta["x"]
        del p, delta, new
    whole = iter(parts)
    return sq, _map_parts(lambda _: next(whole), piece)


def main(argv=None):  # pragma: no cover - thin CLI over the factories
    """CLI: distributed FSA training, one process per mesh position.

        torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
            --device cpu --smoke --steps 20 [--pp 2 --microbatches 2] \\
            [--save DIR]
    """
    import argparse
    import time
    from repro_torch.configs import get_config
    from repro_torch.data import lm_token_batches
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.optim import adam
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--dsc", action="store_true")
    ap.add_argument("--int8-wire", action="store_true")
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipe axis size (contiguous layer stages)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="1F1B microbatch count (must divide --batch)")
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="write the final params as a sharded checkpoint "
                         "directory (the reference's msgpack format; the "
                         "ServeEngine.from_checkpoint handoff)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = init_process_group(args.device)
    try:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
        mesh = make_host_mesh(data=args.data_axis, model=args.model_axis,
                              pipe=args.pp, device=device)
        opt = adam(args.lr)
        settings = TrainSettings(use_dsc=args.dsc, grad_dtype="float32",
                                 int8_wire=args.int8_wire,
                                 microbatches=args.microbatches)
        step = make_train_step(cfg, mesh, opt, settings, device=device)
        key = random.PRNGKey(0)
        params = store_params(tr.init_params(cfg, seed=0, device=device),
                              cfg, mesh, settings)
        opt_state = opt.init(params)
        dsc_ref = init_dsc_state(cfg, mesh, settings, device=device)
        toks = lm_token_batches(key, 1, args.batch, args.seq, cfg.vocab,
                                device=device)[0]
        batch = {"tokens": toks}
        lead = dist.get_rank() == 0
        t0 = time.time()
        for i in range(args.steps):
            params, opt_state, dsc_ref, m = step(
                params, opt_state, dsc_ref, batch, random.PRNGKey(i))
            if lead:
                print(f"step {i:3d} loss={float(m['loss']):.4f} "
                      f"({time.time()-t0:.1f}s)", flush=True)
        if args.save:
            from repro_torch.checkpoint import msgpack_ckpt as ck
            ck.save_sharded(args.save, params,
                            cuts=store_cuts(cfg, mesh, settings))
            if lead:
                print(f"saved sharded checkpoint -> {args.save}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
