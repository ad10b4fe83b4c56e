"""Cross-silo scenario matrix (``repro/core/rounds/scenarios.py``):
composed defenses x failure modes on the real eris wire.

The pack the comparison rests on: FSA composed with the
defenses the paper argues against (SoteriaFL-style LDP noise with an RDP
accountant, Bonawitz pairwise secure-agg masking, the int8 wire format)
crossed with the failure axes of Appendix F.5 (aggregator dropout + link
failure, client dropout through the async buffered runtime).  Each cell
is a declarative :class:`~repro_torch.core.pipeline.RoundPipeline`
stage composition resolved through the method registry: the same
composition runs in the simulator and the scan engine.

Infeasible compositions refuse LOUDLY with the protocol reason instead
of producing silent garbage:

* ``secure_agg`` x any dropout/failure — pairwise masks cancel only in
  the unweighted full-cohort mean (no dropout-recovery round).
* ``dsc_int8`` x ``client_drop`` — DSC's Eq. 4 shift state tracks
  per-round aggregator receipts, which buffered async apply breaks.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

from repro_torch.core import accountant as acct
from repro_torch.core import baselines as bl
from repro_torch.core.compressors import RandP

if TYPE_CHECKING:   # runtime import is lazy: core.fl imports core.rounds
    from repro_torch.core.fl import FLConfig

# Scenario-standard LDP mechanism: per-round (eps=8, delta=1e-5) after
# clipping to unit L2 — loose enough per round that the composed
# accountant curve (not a single round) is the interesting number.
SCENARIO_LDP = bl.LDPConfig(eps=8.0, delta=1e-5, clip=1.0)

DEFENSES: dict[str, dict] = {
    "none": {},
    "int8": dict(int8_wire=True),
    "dsc_int8": dict(use_dsc=True, compressor=RandP(p=0.5),
                     int8_wire=True),
    "ldp": dict(ldp=SCENARIO_LDP),
    "ldp_int8": dict(ldp=SCENARIO_LDP, int8_wire=True),
    "secure_agg": dict(secure_mask=True),
}

FAILURES: dict[str, dict] = {
    "none": {},
    "agg_fail": dict(agg_dropout=0.25, link_failure=0.1),
    "client_drop": dict(client_dropout=0.25),
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the defense x failure matrix."""

    defense: str
    failure: str

    def __post_init__(self):
        if self.defense not in DEFENSES:
            raise ValueError(f"unknown defense {self.defense!r} "
                             f"(have {sorted(DEFENSES)})")
        if self.failure not in FAILURES:
            raise ValueError(f"unknown failure {self.failure!r} "
                             f"(have {sorted(FAILURES)})")

    @property
    def name(self) -> str:
        return f"{self.defense}+{self.failure}"

    @property
    def refusal(self) -> Optional[str]:
        """Why this composition is infeasible (None when it runs)."""
        if self.defense == "secure_agg" and self.failure != "none":
            return ("pairwise masks cancel only in the unweighted "
                    "full-cohort mean; the simplified Bonawitz protocol "
                    "has no dropout-recovery round")
        if self.defense == "dsc_int8" and self.failure == "client_drop":
            return ("DSC's Eq. 4 shift state tracks per-round aggregator "
                    "receipts, which buffered async apply breaks")
        return None

    @property
    def feasible(self) -> bool:
        return self.refusal is None

    @property
    def knobs(self) -> dict:
        return {**DEFENSES[self.defense], **FAILURES[self.failure]}

    @property
    def int8(self) -> bool:
        return bool(self.knobs.get("int8_wire", False))

    @property
    def ldp(self) -> Optional[bl.LDPConfig]:
        return self.knobs.get("ldp")

    @property
    def q(self) -> float:
        """Per-round client sampling/arrival rate (the amplification
        factor the accountant and mi_bound see)."""
        return 1.0 - self.knobs.get("client_dropout", 0.0)

    def fl_config(self, K: int = 6, A: int = 4, rounds: int = 20,
                  lr: float = 0.3, seed: int = 0,
                  keep_views: bool = False) -> "FLConfig":
        """The cell as an FLConfig, resolved by the method registry into
        its stage composition."""
        from repro_torch.core.fl import FLConfig
        if not self.feasible:
            raise ValueError(
                f"scenario {self.name!r} is infeasible: {self.refusal}")
        knobs = self.knobs
        method = "eris_async" if "client_dropout" in knobs else "eris"
        return FLConfig(method=method, K=K, A=A, rounds=rounds, lr=lr,
                        seed=seed, keep_views=keep_views, **knobs)

    def wire_bytes_per_client(self, n: int) -> int:
        """Simulator/scan wire accounting: bytes one client transmits per
        round (the distributed step's per-position number comes from
        ``dist.sharding.mesh_wire_bytes`` instead).  LDP noise and pairwise
        masks are format-preserving; int8 ships 1 B/coord + per-block f32
        scales (padded to QBLOCK)."""
        if self.int8:
            from repro_torch.kernels.quantize import wire_payload_bytes
            return int(wire_payload_bytes(n))
        return 4 * n

    def accountant(self, rounds: int) -> Optional[dict]:
        """Cumulative (eps, delta) across the scenario's rounds for LDP
        cells (RDP composition, subsampling-amplified by q); None when
        no noise stage is active."""
        return acct.ldp_cumulative_epsilon(self.ldp, rounds, q=self.q)


def scenario_matrix(feasible_only: bool = True) -> list[Scenario]:
    cells = [Scenario(d, f) for d in DEFENSES for f in FAILURES]
    return [c for c in cells if c.feasible] if feasible_only else cells


def get(name: str) -> Scenario:
    defense, _, failure = name.partition("+")
    return Scenario(defense, failure or "none")
