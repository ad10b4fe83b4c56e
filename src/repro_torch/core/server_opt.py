"""Server-side federated optimizers (``repro/core/server_opt.py``; paper
Sec. 5 'Benefits').  Each takes the aggregated pseudo-gradient and gives
the model delta; they are coordinate-wise, so under FSA every aggregator
running the same update on its segment equals the centralized update."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class ServerOpt(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any], tuple]
    name: str


def fedavg_server(lr: float) -> ServerOpt:
    return ServerOpt(lambda x: (), lambda v, s: (-lr * v, s), "fedavg")


def _moments(x: torch.Tensor):
    return (torch.zeros(x.shape, dtype=torch.float32, device=x.device),
            torch.zeros(x.shape, dtype=torch.float32, device=x.device))


def fedadam(lr: float, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> ServerOpt:
    """Reddi et al. 2021, Alg. 2 (Adam variant)."""
    def update(v, state):
        m, u = state
        m = b1 * m + (1 - b1) * v
        u = b2 * u + (1 - b2) * v * v
        return -lr * m / (torch.sqrt(u) + tau), (m, u)

    return ServerOpt(_moments, update, "fedadam")


def fedyogi(lr: float, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> ServerOpt:
    """Reddi et al. 2021, Alg. 2 (Yogi variant): sign-controlled second
    moment."""
    def update(v, state):
        m, u = state
        m = b1 * m + (1 - b1) * v
        u = u - (1 - b2) * v * v * torch.sign(u - v * v)
        return -lr * m / (torch.sqrt(torch.abs(u)) + tau), (m, u)

    return ServerOpt(_moments, update, "fedyogi")


def fednova_scale(local_steps: torch.Tensor) -> torch.Tensor:
    """FedNova (Wang et al. 2020) normalization weights for heterogeneous
    local-step counts tau_k (``server_opt.py:61-65``): the per-client
    scale 1 / max(tau_k, 1), f32."""
    return 1.0 / torch.clamp(local_steps.float(), min=1.0)


def get_server_opt(name: str, lr: float) -> ServerOpt:
    return {"fedavg": fedavg_server, "fedadam": fedadam,
            "fedyogi": fedyogi}[name](lr)
