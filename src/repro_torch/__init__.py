"""PyTorch/CUDA port of ``repro`` (ERIS), module for module.

Each subpackage mirrors its counterpart in ``repro``; the port imports
torch, numpy and the standard library only.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``: without a card
they raise rather than carry on on the host (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# On torch 2.13.0+cpu the first call of a transcendental op (log, exp,
# sqrt, erfinv) in a process, when it runs on several threads, can leave
# one thread's share of the output wrong (about one process in four; a
# lazily initialised dispatch raced by the threads).  One call on a single
# element initialises it on this thread first.
torch.log(torch.ones(1))


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card and raises when there is none; any
    explicit device (``"cpu"`` for the tests) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); "
                "pass device='cpu' to run the plain-torch path on the host")
        return torch.device("cuda")
    return torch.device(device)
