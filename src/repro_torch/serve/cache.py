"""Paged KV cache: a global pool of fixed-size blocks + per-request
block tables (``repro/serve/cache.py``).

The pools themselves are tensors created by
``models.transformer.init_paged_pools`` -- (L, N, KV, bs, hd) per layer.
This module owns the HOST side: the free-list :class:`BlockAllocator`
(block 0 is reserved as the scratch block -- inactive engine slots'
tables point at it, so their decode writes land somewhere harmless),
and the prefill scatter that moves a dense prefill cache into a
request's blocks.

Invariants (property-tested in tests/test_torch_paged.py):
  * allocated blocks are unique, nonzero, and within the pool
  * used + free == num_blocks - 1 (the scratch block is neither)
  * ``used`` never exceeds the budget; ``peak_used`` records the max
  * free(alloc(n)) round-trips to the same free count
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

SCRATCH_BLOCK = 0


class BlockBudgetExceeded(RuntimeError):
    """Raised by ``alloc(..., strict=True)`` when the pool is exhausted."""


def pages_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold n_tokens (at least one once tokens exist)."""
    return -(-n_tokens // block_size)


@dataclasses.dataclass
class BlockAllocator:
    """Free-list allocator over pool blocks [1, num_blocks) — block 0 is
    the reserved scratch block and is never handed out."""
    num_blocks: int
    block_size: int

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"scratch block), got {self.num_blocks}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, "
                             f"got {self.block_size}")
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._used: set = set()
        self.peak_used: int = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def used(self) -> int:
        return len(self._used)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1, strict: bool = False) -> Optional[List[int]]:
        """n fresh blocks, or None when the pool can't supply them
        (``strict=True`` raises :class:`BlockBudgetExceeded` instead).
        All-or-nothing: a partial grab is never left allocated."""
        if n > len(self._free):
            if strict:
                raise BlockBudgetExceeded(
                    f"need {n} blocks, {len(self._free)} free "
                    f"(capacity {self.capacity}, used {self.used})")
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._used.update(blocks)
        self.peak_used = max(self.peak_used, len(self._used))
        return blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise ValueError(f"double free / foreign block {b}")
            self._used.remove(b)
            self._free.append(b)


def write_prefill(pools: dict, k: torch.Tensor, v: torch.Tensor,
                  pages: torch.Tensor, block_size: int) -> dict:
    """Scatter one request's dense prefill K/V into its blocks, in place.

    k, v: (L, S, KV, hd) -- the squeezed batch-1 prefill cache; pages:
    (ceil(S_bucket/bs),) pool blocks (pad entries with the scratch
    block).  Positions past the request's true length land either beyond
    its context (masked by attention, overwritten as it grows) or in the
    scratch block -- both harmless, so no length mask is needed.
    Returns ``pools``.
    """
    S = k.shape[1]
    idx = torch.arange(S, device=pages.device)
    page_arr = pages[idx // block_size].long()
    off_arr = idx % block_size
    # pool (L, N, KV, bs, hd) indexed [:, pages, :, offs] puts the
    # advanced dims in front: values go in as (S, L, KV, hd)
    pools["k"][:, page_arr, :, off_arr] = k.transpose(0, 1).to(pools["k"].dtype)
    pools["v"][:, page_arr, :, off_arr] = v.transpose(0, 1).to(pools["v"].dtype)
    return pools
