"""ServeEngine: continuous batching over the paged KV cache
(``repro/serve/engine.py``, the meshless engine).

The engine owns ``max_concurrency`` decode slots.  Every ``step()``:

  1. *evict* -- finished requests free their blocks and leave their slot
     (their table row resets to the scratch block so the now-inactive
     row's decode writes can't alias live blocks);
  2. *admit* -- waiting requests (FIFO) take free slots while the
     allocator can cover their prompt: one prefill, padded up to a
     multiple of ``prefill_bucket``, writes the prompt K/V into fresh
     blocks and samples the first token;
  3. *grow* -- active requests crossing a block boundary allocate their
     next block; when the pool is exhausted the YOUNGEST active request
     is preempted (blocks freed, prefix requeued -- per-token sampling
     streams make the replayed continuation identical);
  4. *decode* -- ONE batched step over all slots
     (``transformer.paged_decode_step``: per-row positions, block-table
     K/V writes, the CUDA paged-attention kernel), then row-wise
     sampling with per-request streams.

Token streams are a function of (params, prompt, SamplingParams, seed)
only -- never of slot, step, or co-resident requests.  The reference
donates its pools to ``jit``; here the pools are updated in place.

With a ``mesh`` (``launch/mesh.make_host_mesh(data, model)``, one process
per position) every rank runs the same host scheduler, holds its model
position's TP piece of the params and its kv heads of the pools
(``dist/sharding.paged_pool_heads``), and decodes under the decode-safe
TP plan (no sequence, context or sequence-CE sharding: one token has no
sequence to shard) through ``paged_decode_step(..., tp=...)``: the CUDA
paged kernel on the rank's local heads, the row-parallel partials summed
over the model group, the logits gathered there.  When the client count
divides the slots (``_manual``, the reference's manual ``shard_map``
body) a rank decodes only its data position's slots, samples them, and
the sampled tokens are gathered over the data group, so that every
rank's scheduler advances alike; otherwise every data rank decodes every
slot.  Prefill runs the TP ``forward`` on every rank, replicated over
"data": each rank writes its kv heads of the prompt into its pools, and
the first token is sampled from the gathered logits.  A rank's pools
receive the decode writes of its own slots only, so the copies on the
data ranks differ, as the reference's do.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, random, resolve_device
from repro_torch.dist import collectives as cl
from repro_torch.dist import sharding as sh
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.serve import cache as pc
from repro_torch.serve.sampling import SamplingParams, sample


@dataclasses.dataclass(frozen=True)
class ServeSettings:
    """Serving configuration."""
    max_concurrency: int = 8       # decode slots (the continuous batch)
    block_size: int = 16           # tokens per KV block
    num_blocks: int = 128          # pool budget incl. the scratch block
    max_model_len: int = 256       # prompt + generation cap per request
    prefill_bucket: int = 32       # prompts pad up to a bucket multiple
    max_new_tokens: int = 32       # default generation budget
    cache_dtype: str = "bfloat16"
    decode_kernel: str = "auto"    # auto | cuda | naive
    window: Optional[int] = None   # sliding window (None: cfg's own)
    eos_id: Optional[int] = None
    sampling: SamplingParams = SamplingParams()
    seed: int = 0

    def __post_init__(self):
        if self.max_concurrency < 1:
            raise ValueError(f"ServeSettings.max_concurrency must be >= 1, "
                             f"got {self.max_concurrency}")
        if self.num_blocks < 2:
            raise ValueError(f"ServeSettings.num_blocks must be >= 2, "
                             f"got {self.num_blocks}")
        if self.block_size < 1:
            raise ValueError(f"ServeSettings.block_size must be >= 1, "
                             f"got {self.block_size}")
        if self.max_model_len < 1:
            raise ValueError(f"ServeSettings.max_model_len must be >= 1, "
                             f"got {self.max_model_len}")
        if self.prefill_bucket < 1:
            raise ValueError(f"ServeSettings.prefill_bucket must be >= 1, "
                             f"got {self.prefill_bucket}")
        if self.decode_kernel not in ("auto", "cuda", "naive"):
            raise ValueError(f"ServeSettings.decode_kernel must be "
                             f"auto|cuda|naive, got {self.decode_kernel}")
        if self.cache_dtype not in tr.DTYPES:
            raise ValueError(f"ServeSettings.cache_dtype must be one of "
                             f"{sorted(tr.DTYPES)}, got {self.cache_dtype}")

    @property
    def max_pages(self) -> int:
        return pc.pages_for(self.max_model_len, self.block_size)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    seed: int
    generated: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: str = ""
    preemptions: int = 0


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    rid: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str          # stop | length
    ttft_s: float               # submit -> first token
    latency_s: float            # submit -> finish
    preemptions: int


class ServeEngine:
    """See module docstring.  ``submit`` + ``step`` for streaming use,
    ``run`` to drain a batch of prompts.  ``device=None`` serves on the
    CUDA card and raises without one; ``device="cpu"`` runs the plain
    torch path on the host.  ``params`` are whole leaves, or with a
    ``mesh`` this rank's TP pieces of them."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 settings: ServeSettings = ServeSettings(), mesh=None,
                 device: DeviceLike = None):
        if cfg.family not in tr.paged_families():
            raise ValueError(
                f"ServeEngine serves families {tr.paged_families()}; "
                f"{cfg.family!r} needs a dense per-request state (use "
                f"transformer.decode_step or sampling.beam_search)")
        self.cfg = cfg
        self.settings = settings
        self.mesh = mesh
        self.device = resolve_device(device)
        self.window = (settings.window if settings.window is not None
                       else cfg.sliding_window)
        C, P = settings.max_concurrency, settings.max_pages
        # the kernel runs meshless, in the manual body and, unlike the
        # reference's GSPMD fallback, in the mesh fallback too
        self._use_kernel = settings.decode_kernel != "naive"
        self._manual = False
        self._tp_plan = None
        self._tp = None
        self._slots = range(C)
        self._data_group = None
        kv_heads = None
        if mesh is not None:
            if sh.pipe_size(mesh) > 1:
                raise ValueError(
                    "ServeEngine serves over a (\"data\", \"model\") mesh; "
                    "a pipe axis splits the layers, which a decode step "
                    "runs all of")
            model = sh.model_size(mesh)
            self._tp_plan = sh.serve_plan(cfg, model)
            n_client = sh.client_count(mesh)
            self._manual = C % n_client == 0
            self._slots = sh.serve_slots(C, mesh)
            if self._manual and n_client > 1:
                self._data_group = mesh.get_group("data")
            midx = sh.axis_rank(mesh, "model")
            if self._tp_plan.active:
                self._tp = tr.TPRuntime(mesh.get_group("model"), model,
                                        midx, self._tp_plan)
            params = sh.tp_piece(params, cfg, model, midx)
            kv_heads = len(sh.paged_pool_heads(cfg, self._tp_plan, model,
                                               midx))
        self.params = _to_device(params, self.device)
        self.pools = tr.init_paged_pools(
            cfg, settings.num_blocks, settings.block_size,
            tr.DTYPES[settings.cache_dtype], self.device, kv_heads)
        self.allocator = pc.BlockAllocator(settings.num_blocks,
                                           settings.block_size)
        self.tables = np.zeros((C, P), np.int32)       # scratch block 0
        self.slots: List[Optional[Request]] = [None] * C
        self.waiting: Deque[Request] = collections.deque()
        self._next_rid = 0
        self._steps = 0
        self._decode_steps = 0
        self._tokens_out = 0
        self._t0: Optional[float] = None

    # ------------------------------------------------------ device closures
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _sample(self, logits, reqs: Sequence[Optional[Request]],
                indices: Sequence[int]) -> np.ndarray:
        """Row-wise sampling, token ``indices[i]`` of request i keyed with
        ``fold_in(PRNGKey(seed), index)`` as the reference keys it; a None
        request is an inactive slot (greedy on garbage logits, discarded
        by the caller)."""
        n = len(reqs)
        keys = torch.zeros((n, 2), dtype=torch.int64)
        temps = np.zeros((n,), np.float32)
        tks = np.zeros((n,), np.int32)
        tps = np.ones((n,), np.float32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            keys[i] = random.fold_in(random.PRNGKey(r.seed), indices[i])
            temps[i] = r.sampling.temperature
            tks[i] = r.sampling.top_k
            tps[i] = r.sampling.top_p
        nxt = sample(keys.to(self.device), logits, self._tensor(temps),
                     self._tensor(tks), self._tensor(tps))
        return nxt.cpu().numpy()

    # -------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               seed: Optional[int] = None) -> int:
        """Queue a request; returns its id.  ``seed`` defaults to the
        request id (folded with ``settings.seed``) -- pass one explicitly
        to make a prompt's stream reproducible across engines."""
        prompt = list(map(int, prompt))
        if not prompt:
            raise ValueError("empty prompt")
        new = (max_new_tokens if max_new_tokens is not None
               else self.settings.max_new_tokens)
        if len(prompt) + new > self.settings.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({new}) exceeds "
                f"max_model_len ({self.settings.max_model_len})")
        if pc.pages_for(len(prompt) + new, self.settings.block_size) > \
                self.allocator.capacity:
            raise ValueError(
                f"request needs more blocks than the pool holds "
                f"(num_blocks={self.settings.num_blocks})")
        rid = self._next_rid
        self._next_rid += 1
        r = Request(rid=rid, prompt=prompt, max_new_tokens=new,
                    sampling=sampling or self.settings.sampling,
                    seed=self.settings.seed * 1_000_003 + (
                        seed if seed is not None else rid),
                    submit_t=time.monotonic())
        self.waiting.append(r)
        return rid

    # ------------------------------------------------------------ plumbing
    def _active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def _ctx_len(self, r: Request) -> int:
        # tokens whose K/V is in cache: prompt + all generated but the
        # newest (the pending decode step writes that one)
        return len(r.prompt) + len(r.generated) - 1

    def _release(self, r: Request) -> None:
        self.allocator.free(r.blocks)
        r.blocks = []
        self.tables[r.slot, :] = pc.SCRATCH_BLOCK
        self.slots[r.slot] = None
        r.slot = -1

    def _evict(self, r: Request, reason: str) -> RequestOutput:
        self._release(r)
        r.finish_t = time.monotonic()
        r.finish_reason = reason
        return RequestOutput(
            rid=r.rid, prompt=r.prompt, tokens=list(r.generated),
            finish_reason=reason,
            ttft_s=(r.first_token_t or r.finish_t) - r.submit_t,
            latency_s=r.finish_t - r.submit_t, preemptions=r.preemptions)

    def _preempt_youngest(self) -> bool:
        """Free the most recently admitted active request and requeue its
        full prefix at the head of the line.  Its sampling stream is
        indexed by token position, so the replay continues the exact same
        stream."""
        victims = self._active()
        if len(victims) <= 1:
            return False
        v = max(victims, key=lambda r: r.rid)
        self._release(v)
        v.preemptions += 1
        self.waiting.appendleft(v)
        return True

    def _admit(self, r: Request, slot: int) -> bool:
        """Prefill ``r``'s prefix (prompt + any pre-preemption tokens)
        into fresh blocks; samples token index len(generated)."""
        s = self.settings
        prefix = r.prompt + r.generated
        n_pages = pc.pages_for(len(prefix) + 1, s.block_size)
        blocks = self.allocator.alloc(n_pages)
        if blocks is None:
            return False
        bucket = -(-len(prefix) // s.prefill_bucket) * s.prefill_bucket
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(prefix)] = prefix
        # pad entries point at the scratch block, so the bucket's padded
        # tail lands there (or beyond the context in the last real page)
        pages = np.full((max(s.max_pages, pc.pages_for(bucket, s.block_size),
                             n_pages),), pc.SCRATCH_BLOCK, np.int64)
        pages[:n_pages] = blocks
        logits, caches, _ = tr.forward(self.params, self.cfg,
                                       self._tensor(toks), mode="prefill",
                                       window=self.window, tp=self._tp)
        pc.write_prefill(self.pools, caches["kv"]["k"][:, 0],
                         caches["kv"]["v"][:, 0], self._tensor(pages),
                         s.block_size)
        # the first token comes from the last real position, not from the
        # bucket's zero-padded tail
        last = logits[0, len(prefix) - 1][None]
        if self._tp is not None and self._tp_plan.vocab:
            last = cl.all_gather(last, self._tp.group, 1)
        first = self._sample(last, [r], [len(r.generated)])[0]
        r.generated.append(int(first))
        if r.first_token_t is None:
            r.first_token_t = time.monotonic()
        self._tokens_out += 1
        r.slot = slot
        r.blocks = blocks
        self.slots[slot] = r
        self.tables[slot, :] = pc.SCRATCH_BLOCK
        self.tables[slot, :n_pages] = blocks
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> List[RequestOutput]:
        """One engine iteration: evict / admit / grow / batched decode.
        Returns the requests that finished during this step."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._steps += 1
        finished = self._schedule()
        active = self._active()
        if not active:
            return finished
        tables, ctxs, toks, indices = self._decode_batch()
        logits, self.pools = tr.paged_decode_step(
            self.params, self.cfg, self.pools, tables, ctxs, toks,
            window=self.window, use_kernel=self._use_kernel, tp=self._tp)
        self._decode_steps += 1
        mine = self._slots
        nxt = self._sample(logits[:, 0], self.slots[mine.start:mine.stop],
                           indices)
        if self._data_group is not None:
            # every rank's scheduler takes every slot's token
            nxt = cl.all_gather(torch.from_numpy(nxt), self._data_group,
                                0).numpy()
        now = time.monotonic()
        for r in active:
            r.generated.append(int(nxt[r.slot]))
            self._tokens_out += 1
            if r.first_token_t is None:
                r.first_token_t = now
            if self._done(r):
                finished.append(self._evict(r, self._done(r)))
        return finished

    def _decode_batch(self):
        """The batched decode step's inputs over this rank's slots (all of
        them meshless), on the device: (tables, ctxs, toks, token
        indices).  Inactive slots decode token 0 at ctx 0 through an
        all-scratch table."""
        C = self.settings.max_concurrency
        toks = np.zeros((C, 1), np.int64)
        ctxs = np.zeros((C,), np.int32)
        indices = [0] * C
        for r in self._active():
            toks[r.slot, 0] = r.generated[-1]
            ctxs[r.slot] = self._ctx_len(r)
            indices[r.slot] = len(r.generated)
        mine = slice(self._slots.start, self._slots.stop)
        return (self._tensor(self.tables[mine]), self._tensor(ctxs[mine]),
                self._tensor(toks[mine]), indices[mine])

    def _schedule(self) -> List[RequestOutput]:
        """Evict, admit and grow: afterwards every active request owns the
        page its pending decode writes.  Returns the requests that
        finished on the way (including first-token-only completions)."""
        s = self.settings
        finished: List[RequestOutput] = []

        # evict finished (incl. first-token-only completions from admit)
        for r in list(self._active()):
            if self._done(r):
                finished.append(self._evict(r, self._done(r)))

        # admit waiting into free slots
        for slot in range(s.max_concurrency):
            if not self.waiting or self.slots[slot] is not None:
                continue
            if not self._admit(self.waiting[0], slot):
                break
            r = self.waiting.popleft()
            if self._done(r):
                finished.append(self._evict(r, self._done(r)))

        # grow: the pending decode writes at position ctx -- make sure its
        # page exists; preempt the youngest request when the pool is dry.
        # A preempted r (slot -1) drops out of the loop: it re-enters
        # through admission, not growth.
        for r in list(self._active()):
            while r.slot >= 0 and \
                    pc.pages_for(self._ctx_len(r) + 1, s.block_size) > \
                    len(r.blocks):
                nb = self.allocator.alloc(1)
                if nb is None:
                    if self._preempt_youngest():
                        continue
                    raise pc.BlockBudgetExceeded(
                        "pool exhausted with a single active request -- "
                        "num_blocks cannot cover max_model_len")
                if r.slot < 0:
                    self.allocator.free(nb)     # r itself was preempted
                    break
                self.tables[r.slot, len(r.blocks)] = nb[0]
                r.blocks.extend(nb)
        return finished

    def _done(self, r: Request) -> str:
        if self.settings.eos_id is not None and r.generated and \
                r.generated[-1] == self.settings.eos_id:
            return "stop"
        if len(r.generated) >= r.max_new_tokens:
            return "length"
        return ""

    def run(self, prompts: Optional[Sequence[Sequence[int]]] = None,
            **submit_kw) -> List[RequestOutput]:
        """Submit ``prompts`` (optional) and drain the engine.  Outputs
        are returned sorted by request id."""
        for p in prompts or ():
            self.submit(p, **submit_kw)
        outs: List[RequestOutput] = []
        while self.waiting or self._active():
            outs.extend(self.step())
        return sorted(outs, key=lambda o: o.rid)

    # ---------------------------------------------------------------- misc
    def stats(self) -> dict:
        elapsed = (time.monotonic() - self._t0) if self._t0 else 0.0
        return {
            "steps": self._steps,
            "decode_steps": self._decode_steps,
            "tokens_out": self._tokens_out,
            "tokens_per_s": self._tokens_out / elapsed if elapsed else 0.0,
            "peak_blocks": self.allocator.peak_used,
            "block_capacity": self.allocator.capacity,
        }

    @classmethod
    def from_checkpoint(cls, path, cfg: ModelConfig,
                        settings: ServeSettings = ServeSettings(), mesh=None,
                        device: DeviceLike = None) -> "ServeEngine":
        """Serve a ``launch/train.py --save`` artifact (a sharded msgpack
        directory, whatever (data, pipe, model) mesh wrote it, or a
        single-file checkpoint): the store->use handoff, in the dtype the
        leaves were saved in, straight onto ``device``.  Meshless it
        restores whole leaves; with a ``mesh`` only this rank's TP pieces
        (``dist/sharding.tp_cuts``), so no rank holds the whole model."""
        from repro_torch.checkpoint import msgpack_ckpt as ck
        target = sh.shape_tree(cfg, lambda shape: torch.empty(shape,
                                                              device="meta"))
        cuts = None
        if mesh is not None:
            cuts = sh.tp_cuts(cfg, sh.model_size(mesh),
                              sh.axis_rank(mesh, "model"))
        device = resolve_device(device)
        params = ck.restore_any(path, target, cuts=cuts, device=device)
        return cls(cfg, params, settings, mesh=mesh, device=device)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
