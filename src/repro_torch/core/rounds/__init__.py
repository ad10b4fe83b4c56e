"""Declarative FL method registry (``repro/core/rounds``): method name ->
RoundPipeline."""
from repro_torch.core.rounds.registry import METHODS, build_round  # noqa: F401
