"""Token selection: temperature / top-k / top-p sampling, greedy, and
beam search (``repro/serve/sampling.py``).

``sample`` is row-wise: temperature/top_k/top_p come in as per-row
tensors, so one decode step serves every request's sampling settings at
once, and each row draws with its own threefry key, as the reference's
``vmap(jax.random.categorical)``: Gumbel noise over the vocabulary added
to the filtered logits, then the argmax.  The engine keys token i of a
request with ``fold_in(PRNGKey(seed), i)``, so a request's stream depends
only on its own seed and history, never on its batch or slot: batched
output is token-identical to solo output, and to the reference's for the
same seed (the Gumbel noise agrees with jax's to a few ulps,
``repro_torch.random.gumbel``).

``beam_search`` is the offline decode on the dense ring cache
(``transformer.decode_step``), the one way the reference serves the
recurrent families: fixed-width beams, the cache reordered by parent
beam each step, an optional EOS with length-penalised scores.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random
from repro_torch.convert import tree_map
from repro_torch.models import transformer as tr
from repro_torch.models.moe import sorted_top_k

NEG_INF = -1e30
_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 selects greedy; top_k == 0 / top_p == 1 disable
    the respective filters."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"SamplingParams.temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"SamplingParams.top_k must be >= 0, "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"SamplingParams.top_p must be in (0, 1], "
                             f"got {self.top_p}")


def sample(keys: torch.Tensor, logits: torch.Tensor,
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor) -> torch.Tensor:
    """Per-row token selection.  keys: (B, 2) threefry keys on the logits'
    device; logits: (B, V); temperature/top_k/top_p: (B,).  Order of the
    filters, as the reference: temperature scale -> top-k -> top-p on the
    sorted probabilities -> categorical draw; temperature 0
    short-circuits to the argmax (the first maximum).  Returns (B,)
    int32."""
    B, V = logits.shape
    greedy = logits.argmax(-1)
    scaled = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True,
                                      stable=True)
    ranks = torch.arange(V, device=logits.device)[None, :]
    # top-k: keep sorted positions < k (k == 0 disables)
    k_eff = torch.where(top_k > 0, top_k.clamp(1, V), V)
    keep = ranks < k_eff[:, None]
    # top-p: keep the smallest prefix of the sorted distribution whose
    # mass reaches p (the first token always survives: cum - prob == 0)
    probs = torch.softmax(sorted_logits.masked_fill(~keep, NEG_INF), -1)
    cum = probs.cumsum(-1)
    keep &= (cum - probs) < top_p[:, None]
    filtered = torch.empty_like(scaled).scatter_(
        -1, order, sorted_logits.masked_fill(~keep, NEG_INF))
    drawn = random.categorical(keys, filtered)
    return torch.where(temperature <= 0, greedy, drawn).to(torch.int32)


def sample_one(key: torch.Tensor, logits: torch.Tensor,
               params: SamplingParams) -> torch.Tensor:
    """One row through :func:`sample` (``sampling.py:75-81``): key (2,),
    logits (V,); returns a 0-d int32 token."""
    dev = logits.device
    return sample(key[None], logits[None],
                  torch.tensor([params.temperature], dtype=torch.float32,
                               device=dev),
                  torch.tensor([params.top_k], dtype=torch.int32,
                               device=dev),
                  torch.tensor([params.top_p], dtype=torch.float32,
                               device=dev))[0]


# ============================================================ beam decode
def prefill_cache(params: dict, cfg, prompt: torch.Tensor, n_beams: int,
                  cache_len: int, window: Optional[int] = None,
                  cache_dtype: torch.dtype = torch.float32):
    """The prompt's prefill, its cache in the dense decode layout for
    ``n_beams`` copies of it: ssm's states repeated whole; the K/V rings
    of ``init_cache(cfg, n_beams, cache_len, window)`` with absolute
    position j at slot j % size (under a window only the last ``size``
    positions, older ones are never valid), and hybrid's SSM state beside
    them.  prompt: (S,) on the params' device.  Returns (the prefill's
    logits (1, S, V), the cache)."""
    S = prompt.shape[0]
    logits, caches, _ = tr.forward(params, cfg, prompt[None], "prefill",
                                   window)

    def beams(c):
        return c.repeat_interleave(n_beams, 1)

    if cfg.family == "ssm":
        return logits, tree_map(beams, caches)
    cache = tr.init_cache(cfg, n_beams, cache_len, window=window,
                          dtype=cache_dtype, device=prompt.device)
    size = cache["kv"]["k"].shape[2]
    lo = max(0, S - size)
    slots = torch.arange(lo, S, device=prompt.device) % size
    for n in ("k", "v"):
        cache["kv"][n][:, :, slots] = beams(
            caches["kv"][n][:, :, lo:]).to(cache_dtype)
    if cfg.family == "hybrid":
        cache["ssm"] = beams(caches["ssm"]).to(cache["ssm"].dtype)
    return logits, cache


def beam_search(params: dict, cfg, prompt, *, n_beams: int = 4,
                max_new_tokens: int = 16, window: Optional[int] = None,
                eos_id: Optional[int] = None, length_penalty: float = 1.0,
                cache_dtype: torch.dtype = torch.float32):
    """Fixed-width beam decode of one prompt on the dense decode cache
    (``sampling.py:85-160``), on the params' device.

    prompt: (S,) ints.  The prefill's cache goes into the decode layout,
    one copy a beam (:func:`prefill_cache`).  Each step extends every
    beam by every token, keeps the ``n_beams`` best sums of log-probs
    (``lax.top_k``'s order: ties to the lower index) and reorders the
    cache by parent beam; a finished beam (it drew ``eos_id``) extends
    only by EOS at no cost.  Returns
    (tokens (max_new_tokens,) int32, score) of the best beam: its summed
    log-prob over max_new_tokens ** length_penalty."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    S = prompt.shape[0]
    total = S + max_new_tokens
    logits, cache = prefill_cache(params, cfg, prompt, n_beams, total,
                                  window=window, cache_dtype=cache_dtype)
    logp0 = torch.log_softmax(logits[0, S - 1].float(), -1)
    scores, first = sorted_top_k(logp0, n_beams)
    V = logp0.shape[0]
    toks = first.to(torch.int32)
    seqs = torch.zeros(n_beams, max_new_tokens, dtype=torch.int32,
                       device=device)
    seqs[:, 0] = toks
    alive = torch.ones(n_beams, dtype=torch.bool, device=device)
    if eos_id is not None:
        alive &= toks != eos_id
        frozen = torch.full((n_beams, V), NEG_INF, device=device)
        frozen[:, eos_id] = 0.0
    for pos in range(S, total - 1):
        logits, cache = tr.decode_step(params, cfg, cache, toks[:, None],
                                       pos, window=window)
        logp = torch.log_softmax(logits[:, 0].float(), -1)
        if eos_id is not None:
            logp = torch.where(alive[:, None], logp, frozen)
        cand = scores[:, None] + logp                       # (beams, V)
        scores, top_i = sorted_top_k(cand.reshape(-1), n_beams)
        parent = top_i // V
        toks = (top_i % V).to(torch.int32)
        cache = tree_map(lambda c: c[:, parent], cache)
        seqs = seqs[parent]
        seqs[:, pos - S + 1] = toks
        alive = alive[parent]
        if eos_id is not None:
            alive &= toks != eos_id
    norm = scores / (max_new_tokens ** length_penalty)
    best = int(torch.argmax(norm))
    return seqs[best], norm[best]
