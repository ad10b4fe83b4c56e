"""Token selection: temperature / top-k / top-p sampling and greedy
(``repro/serve/sampling.py``; ``beam_search`` is not ported yet).

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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random

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
