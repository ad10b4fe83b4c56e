"""Optimizers (``repro/optim``) on trees of tensors."""
from repro_torch.optim.optimizers import (AdamState, Optimizer, adam,  # noqa: F401
                                          momentum, sgd)
