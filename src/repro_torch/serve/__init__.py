"""Serving subsystem: continuous batching over a paged KV cache
(``repro/serve``).

``ServeEngine`` (engine.py) is the request loop -- admission, batched
decode, eviction -- over the block-pool cache (cache.py), with
temperature/top-k/top-p/greedy sampling (sampling.py).  The public
surface re-exports through ``repro_torch.launch.serve``.
"""
from repro_torch.serve.cache import (BlockAllocator,  # noqa: F401
                                     BlockBudgetExceeded, pages_for,
                                     write_prefill)
from repro_torch.serve.engine import (Request, RequestOutput,  # noqa: F401
                                      ServeEngine, ServeSettings)
from repro_torch.serve.sampling import SamplingParams, sample  # noqa: F401
