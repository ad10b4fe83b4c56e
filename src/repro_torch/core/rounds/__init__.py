"""Declarative FL method registry (``repro/core/rounds``): method name ->
RoundPipeline, plus the cross-silo scenario matrix (defense x failure
compositions)."""
from repro_torch.core.rounds.registry import METHODS, build_round  # noqa: F401
from repro_torch.core.rounds.scenarios import (  # noqa: F401
    DEFENSES, FAILURES, Scenario, scenario_matrix)
