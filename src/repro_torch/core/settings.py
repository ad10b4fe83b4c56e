"""Shared settings layer (``repro/core/settings.py``): the async-runtime
knobs spoken by BOTH config surfaces.

``FLConfig`` (the simulator/scan engines) and ``TrainSettings`` (the
distributed runtime) used to carry five duplicated fields —
``population``, ``buffer_cadence``, ``staleness_alpha``, ``delay_max``,
``client_dropout`` — each validating (or forgetting to validate) them
independently.  :class:`AsyncSettings` is the single frozen dataclass
both consume: construction validates every field with an error naming
it, and the owners' flat legacy knobs resolve against an explicitly
provided ``AsyncSettings`` with a conflict error that also names the
field (set each knob in ONE place).

The flat fields stay on ``FLConfig``/``TrainSettings``; the rounds
registry consumes ``.async_settings()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.pipeline import ArrivalModel, CohortSample

ASYNC_FIELDS = ("population", "buffer_cadence", "staleness_alpha",
                "delay_max", "client_dropout")


@dataclasses.dataclass(frozen=True)
class AsyncSettings:
    """The population-scale async runtime knobs (fedbuff / eris_async
    methods and ``TrainSettings.async_buffer``), validated on
    construction.

    population       >0: batches carry the whole population on their
                     leading axis; the per-round cohort is drawn from it
    buffer_cadence   server applies the buffer every C rounds
    staleness_alpha  arrival weight 1/(1+tau)^alpha
    delay_max        straggler staleness tau ~ U{0..delay_max}
    client_dropout   arrival dropout (never contributes)
    """
    population: int = 0
    buffer_cadence: int = 1
    staleness_alpha: float = 1.0
    delay_max: int = 0
    client_dropout: float = 0.0

    def __post_init__(self):
        if self.population < 0:
            raise ValueError(f"AsyncSettings.population must be >= 0, "
                             f"got {self.population}")
        if self.buffer_cadence < 1:
            raise ValueError(f"AsyncSettings.buffer_cadence must be >= 1, "
                             f"got {self.buffer_cadence}")
        if self.staleness_alpha < 0:
            raise ValueError(f"AsyncSettings.staleness_alpha must be >= 0, "
                             f"got {self.staleness_alpha}")
        if self.delay_max < 0:
            raise ValueError(f"AsyncSettings.delay_max must be >= 0, "
                             f"got {self.delay_max}")
        if not 0.0 <= self.client_dropout <= 1.0:
            # 1.0 (everyone drops) is legal — the fedbuff property tests
            # use it to prove dropped arrivals contribute zero weight
            raise ValueError(f"AsyncSettings.client_dropout must be in "
                             f"[0, 1], got {self.client_dropout}")

    # ------------------------------------------------ derived pipeline bits
    def arrival_model(self) -> ArrivalModel:
        return ArrivalModel(delay_max=self.delay_max,
                            dropout=self.client_dropout,
                            alpha=self.staleness_alpha)

    def cohort(self, K: int) -> Optional[CohortSample]:
        """Keyed per-round cohort draw, or None when population-scale
        selection is off."""
        if not self.population:
            return None
        if self.population < K:
            raise ValueError(
                f"AsyncSettings.population ({self.population}) must be >= "
                f"cohort size K ({K})")
        return CohortSample(population=self.population, cohort=K)

    # --------------------------------------------------------- construction
    @classmethod
    def from_knobs(cls, obj) -> "AsyncSettings":
        """Build from any object carrying (a subset of) the flat legacy
        knobs — FLConfig, TrainSettings, or a duck-typed stand-in."""
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        return cls(**{name: getattr(obj, name, defaults[name])
                      for name in ASYNC_FIELDS})


def resolve_async(owner: str, explicit: Optional[AsyncSettings],
                  obj) -> AsyncSettings:
    """Resolve an owner's async knobs: its flat legacy fields, or an
    explicitly attached :class:`AsyncSettings` — never a disagreeing mix.

    A flat field that moved off its default while ``explicit`` says
    something else is a configuration bug; the error names the field so
    the caller knows exactly which knob is set in two places.
    """
    flat = AsyncSettings.from_knobs(obj)
    if explicit is None:
        return flat
    defaults = AsyncSettings()
    for name in ASYNC_FIELDS:
        flat_v, exp_v = getattr(flat, name), getattr(explicit, name)
        if flat_v != getattr(defaults, name) and flat_v != exp_v:
            raise ValueError(
                f"{owner}.{name}={flat_v!r} conflicts with "
                f"AsyncSettings.{name}={exp_v!r}: set the async knob in "
                f"one place (the flat field is deprecated; prefer "
                f"AsyncSettings)")
    return explicit
