"""Family-generic model-axis shard plans (``repro/models/shard_plan.py``).

What the ``model`` axis of a mesh shards, for every family of the config
zoo.  Three objects:

* :class:`TPPlan` -- the static per-config decision: which *regions*
  (attn / ffn / vocab / moe / mixer) shard, and whether the activations
  between regions are sequence-sharded (``seq``).
* :class:`TPRuntime` -- the per-step context threaded through
  ``transformer.forward``: the model axis's process group, its size, this
  rank's index in it, and the plan.
* :class:`TPSpec` -- the placement of one parameter leaf, derived from
  the role each ``param_spec`` entry plays (:data:`PARAM_ROLES`).

Regions by family (each wired through the conjugate collectives of
``models/layers``):

* ``attn``  -- Megatron column/row pairing of wq/wk/wv with wo; needs
  heads AND kv-heads divisible.
* ``ffn``   -- column/row pairing of the gated MLP (w_gate/w_up with
  w_down; the ssm family's p_up/p_gate with p_down).
* ``vocab`` -- vocab-parallel embedding, column-parallel unembed, and the
  CE on vocab-sharded logits.
* ``moe``   -- expert parallelism: the expert dim of w_gate/w_up/w_down
  shards; tokens reach their experts by an ``all_to_all``
  (``models/moe.moe_ffn``); the router stays replicated with partial
  gradients.
* ``mixer`` -- recurrent mixers run local: the mLSTM shards heads, the
  hybrid's selective SSM shards channels (m_in/m_bc stay replicated with
  partial gradients).

``seq`` (sequence parallelism, the dense families' opt-in through
``ModelConfig.seq_parallel``) turns each region's all-reduce pair into
reduce-scatter / all-gather conjugates: the norm and residual regions
hold (B, S/tp, D).  It needs ``ffn`` and ``vocab``; a replicated
attention region under it is entered with a gather and left with this
rank's sequence slice, which makes its leaves ``partial``.

The plans, specs and the pipeline schedule are plain Python: the tests
hold them equal to the reference's for every zoo config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple


# ============================================================== TPPlan
@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What the model axis shards for one config (static).  Field order
    (size, attn, ffn, vocab) is positional API, as the reference's."""

    size: int = 1
    attn: bool = False
    ffn: bool = False
    vocab: bool = False
    moe: bool = False        # expert-parallel MoE dispatch/combine
    mixer: bool = False      # head/channel-sharded recurrent mixer
    seq: bool = False        # sequence-sharded inter-region activations
    ctx: int = 1             # ring-attention factor of the model axis
    seq_ce: bool = False     # sequence-scatter the final norm (ssm/hybrid)

    @property
    def active(self) -> bool:
        return self.size > 1 and (self.attn or self.ffn or self.vocab
                                  or self.moe or self.mixer
                                  or self.ctx > 1)


class TPRuntime(NamedTuple):
    """The model axis of one step: its ``torch.distributed`` process
    group, its size, this rank's index in it (the reference's
    ``axis_index``), and the plan."""

    group: Any
    size: int
    index: int
    plan: TPPlan


# ======================================================== plan builders
def _attn_divides(cfg, size: int) -> bool:
    return cfg.n_heads % size == 0 and cfg.n_kv_heads % size == 0


def _ctx_factor(cfg, size: int, attn: bool) -> int:
    """Ring-attention factor: where head sharding cannot divide (odd
    head counts, GQA kv < tp) the attention region shards the sequence
    over the whole model axis instead; any size qualifies, and the
    runtime falls back per call when S itself does not divide."""
    if attn or size <= 1 or cfg.attn_batch_shard:
        return 1
    return size


def _plan_dense(cfg, size: int) -> TPPlan:
    ffn = cfg.d_ff > 0 and cfg.d_ff % size == 0
    vocab = cfg.vocab % size == 0
    attn = _attn_divides(cfg, size)
    # seq needs the CE on vocab-sharded logits and a sharded FFN; the vlm
    # frontend's concat would break the uniform sequence shards
    seq = (cfg.seq_parallel and ffn and vocab and cfg.frontend == "none")
    return TPPlan(size, attn=attn, ffn=ffn, vocab=vocab, seq=seq,
                  ctx=_ctx_factor(cfg, size, attn))


def _plan_moe(cfg, size: int) -> TPPlan:
    attn = _attn_divides(cfg, size)
    return TPPlan(size, attn=attn,
                  vocab=cfg.vocab % size == 0,
                  moe=cfg.n_experts > 0 and cfg.n_experts % size == 0,
                  ctx=_ctx_factor(cfg, size, attn))


def _plan_ssm(cfg, size: int) -> TPPlan:
    # mixer = mLSTM heads; ffn = the gated in-block projection (2 D wide)
    vocab = cfg.vocab % size == 0
    return TPPlan(size, ffn=(2 * cfg.d_model) % size == 0,
                  vocab=vocab,
                  mixer=cfg.n_heads % size == 0,
                  seq_ce=cfg.seq_parallel and vocab)


def _plan_hybrid(cfg, size: int) -> TPPlan:
    attn = _attn_divides(cfg, size)
    vocab = cfg.vocab % size == 0
    return TPPlan(size, attn=attn,
                  ffn=cfg.d_ff > 0 and cfg.d_ff % size == 0,
                  vocab=vocab,
                  mixer=cfg.d_model % size == 0,
                  ctx=_ctx_factor(cfg, size, attn),
                  seq_ce=cfg.seq_parallel and vocab)


_PLAN_BUILDERS = {"dense": _plan_dense, "audio": _plan_dense,
                  "vlm": _plan_dense, "moe": _plan_moe,
                  "ssm": _plan_ssm, "hybrid": _plan_hybrid}


def build_plan(cfg, size: int) -> TPPlan:
    """The model-axis plan for ``cfg`` at ``size`` shards; a family with
    no builder replicates (an inactive plan)."""
    builder = _PLAN_BUILDERS.get(cfg.family)
    if size <= 1 or builder is None:
        return TPPlan(size=max(size, 1))
    return builder(cfg, size)


# the historical name (re-exported by models.transformer)
tp_plan = build_plan


# ============================================================== TPSpec
@dataclasses.dataclass(frozen=True)
class TPSpec:
    """Model-axis placement of one parameter leaf (stacked shapes).

    ``kind``: ``col`` / ``row`` (a Megatron shard at ``dim``),
    ``expert`` (the expert dim), ``vocab`` (embedding rows): gradients
    local to the shard.  ``replicate``: the same on every model rank, its
    gradient complete on each.  ``partial``: replicated values consumed
    on local shards only (qk-norm scales over local heads, the router
    over local token groups, norm scales over sequence slices): each
    rank's gradient is a partial sum that the step all-reduces over the
    model axis (``dist.sharding.tp_grad_sync``)."""

    dim: int = -1
    kind: str = "replicate"


_REP = TPSpec()
_PARTIAL = TPSpec(-1, "partial")

# leaf name -> (region, dim, kind); a leaf shards iff its region is
# active in the plan
_ATTN_ROLES = {"wq": ("attn", 2, "col"), "wk": ("attn", 2, "col"),
               "wv": ("attn", 2, "col"), "wo": ("attn", 1, "row"),
               "bq": ("attn", 1, "col"), "bk": ("attn", 1, "col"),
               "bv": ("attn", 1, "col"),
               "q_norm": ("attn", -1, "partial"),
               "k_norm": ("attn", -1, "partial")}

_FFN_ROLES = {"w_gate": ("ffn", 2, "col"), "w_up": ("ffn", 2, "col"),
              "w_down": ("ffn", 1, "row")}

PARAM_ROLES = {
    "dense": {**_ATTN_ROLES, **_FFN_ROLES},
    "moe": {**_ATTN_ROLES,
            "router": ("moe", -1, "partial"),
            "w_gate": ("moe", 1, "expert"), "w_up": ("moe", 1, "expert"),
            "w_down": ("moe", 1, "expert")},
    "ssm": {"xq": ("mixer", 2, "col"), "xk": ("mixer", 2, "col"),
            "xv": ("mixer", 2, "col"), "xo": ("mixer", 1, "row"),
            "w_i": ("mixer", 2, "col"), "w_f": ("mixer", 2, "col"),
            "b_i": ("mixer", 1, "col"), "b_f": ("mixer", 1, "col"),
            "p_up": ("ffn", 2, "col"), "p_gate": ("ffn", 2, "col"),
            "p_down": ("ffn", 1, "row")},
    "hybrid": {**_ATTN_ROLES, **_FFN_ROLES,
               "m_dt": ("mixer", 2, "col"), "m_A": ("mixer", 1, "col"),
               "m_D": ("mixer", 1, "col"), "m_ln": ("mixer", 1, "col"),
               "m_out": ("mixer", 1, "row"),
               "m_in": ("mixer", -1, "partial"),
               "m_bc": ("mixer", -1, "partial")},
}
PARAM_ROLES["audio"] = PARAM_ROLES["dense"]
PARAM_ROLES["vlm"] = PARAM_ROLES["dense"]

_NORM_LEAVES = ("ln1", "ln2")        # block norms consumed on seq shards


def _leaf_spec(plan: TPPlan, roles: dict, name: str) -> TPSpec:
    if name in _NORM_LEAVES:
        # consumed on (B, S/tp, D) residual shards under a seq plan
        return _PARTIAL if plan.seq else _REP
    role = roles.get(name)
    if role is None:
        return _REP
    region, dim, kind = role
    if getattr(plan, region):
        return TPSpec(dim, kind)
    if region == "attn" and (plan.seq or plan.ctx > 1):
        # a replicated attention region applied to this rank's sequence
        # slice (the seq fallback) or chunk (the ring): partial sums
        return _PARTIAL
    return _REP


def tp_specs(cfg, size: int) -> dict:
    """A tree of :class:`TPSpec` matching the parameter tree: every entry
    of ``models/transformer.param_spec`` placed by its
    :data:`PARAM_ROLES` role under the family's plan."""
    from repro_torch.models import transformer as tr
    plan = build_plan(cfg, size)
    roles = PARAM_ROLES.get(cfg.family, {})
    spec = tr.param_spec(cfg)
    out: dict = {}
    for name in spec:
        if name == "blocks":
            out["blocks"] = {bn: _leaf_spec(plan, roles, bn)
                             for bn in spec["blocks"]}
        elif name == "embed":
            out["embed"] = TPSpec(0, "vocab") if plan.vocab else _REP
        elif name == "lm_head":
            out["lm_head"] = TPSpec(1, "col") if plan.vocab else _REP
        elif name == "ln_f" and (plan.seq or plan.seq_ce):
            out["ln_f"] = _PARTIAL          # consumed on sequence shards
        else:                               # ln_f (non-seq), proj_in
            out[name] = _REP
    return out


# ======================================================== PipelinePlan
@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """What the ``pipe`` axis shards for one config (static): ``size``
    contiguous stages of ``layers_per_stage`` layers each, stage s owning
    rows [s lps, (s + 1) lps) of every block leaf's stacked dim 0; the
    other leaves replicate over ``pipe``.  The pipelined step itself is
    ROADMAP queue 1.10."""

    size: int = 1
    n_layers: int = 0
    microbatches: int = 1

    @property
    def active(self) -> bool:
        return self.size > 1

    @property
    def layers_per_stage(self) -> int:
        return self.n_layers // max(self.size, 1)

    @property
    def bubble_fraction(self) -> float:
        """Idle share of the microbatch-grid scan: (p-1)/(m+p-1)."""
        if self.size <= 1:
            return 0.0
        return (self.size - 1) / (self.microbatches + self.size - 1)


class PipeRuntime(NamedTuple):
    """The pipe axis of one step: its process group, size, this rank's
    stage, and the plan."""

    group: Any
    size: int
    index: int
    plan: PipelinePlan


# every zoo family stacks its block leaves at dim 0
PIPELINE_FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")


def build_pipeline_plan(cfg, size: int,
                        microbatches: int = 1) -> PipelinePlan:
    """The pipe-axis plan for ``cfg`` at ``size`` stages: inactive when
    the family is unknown or the layers do not split into equal
    contiguous stages."""
    if (size <= 1 or cfg.family not in PIPELINE_FAMILIES
            or cfg.n_layers % size != 0):
        return PipelinePlan(size=1, n_layers=cfg.n_layers,
                            microbatches=max(microbatches, 1))
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    return PipelinePlan(size=size, n_layers=cfg.n_layers,
                        microbatches=microbatches)


def pipeline_schedule(size: int, microbatches: int) -> list:
    """The interleaved 1F1B order: a list of (stage, microbatch, 'F' |
    'B') in global execution order.  Stage s runs forward i at tick
    i + s and backward i at tick (m + p - 1) + (p - 1 - s) + i; emitting
    by tick gives a legal order."""
    p, m = size, microbatches
    order: list = []
    nf = [0] * p
    nb = [0] * p
    fwd_tick = {(s, i): i + s for s in range(p) for i in range(m)}
    bwd_tick = {(s, i): (m + p - 1) + (p - 1 - s) + i
                for s in range(p) for i in range(m)}
    events = ([(t, s, i, "F") for (s, i), t in fwd_tick.items()]
              + [(t, s, i, "B") for (s, i), t in bwd_tick.items()])
    for t, s, i, d in sorted(events):
        if d == "F":
            assert nf[s] == i
            nf[s] += 1
        else:
            assert nb[s] == i and nf[s] > i
            nb[s] += 1
        order.append((s, i, d))
    return order
