"""Moments/RDP accountant for the composed LDP scenarios
(``repro/core/accountant.py``, pure Python, carried over whole).

The LDP defense (`pipeline.LDPNoise` / `baselines.ldp_perturb`) clips
each client update to ``clip`` and adds Gaussian noise calibrated by
`baselines.gaussian_sigma` for a SINGLE-round (eps, delta) guarantee.
Across a T-round scenario the privacy loss composes; naive composition
(T*eps) is hopelessly loose, so the scenario pack tracks the cumulative
(eps, delta) with a Renyi-DP accountant (Mironov 2017; subsampled
amplification per Wang/Balle/Kasiviswanathan 2019 for integer orders;
the moments-accountant bound of Abadi et al. 2016 is the same object).

Everything here is plain Python/ math — the accountant runs at
snapshot/report time, never inside a round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core import baselines as bl

# Integer Renyi orders: dense low range (tight for large noise) plus a
# spread tail (tight for small noise / many rounds).
DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 33)) + (
    40, 48, 64, 96, 128, 192, 256, 384, 512)


def rdp_gaussian(alpha: float, noise_multiplier: float) -> float:
    """RDP of the Gaussian mechanism at order alpha: alpha / (2 z^2)."""
    if noise_multiplier <= 0:
        return math.inf
    return alpha / (2.0 * noise_multiplier ** 2)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_subsampled_gaussian(alpha: int, q: float,
                            noise_multiplier: float) -> float:
    """RDP at integer order alpha of the Poisson-subsampled Gaussian
    mechanism (sampling rate q, noise multiplier z = sigma/sensitivity):

        (1/(alpha-1)) log sum_{k=0}^{alpha} C(alpha,k) (1-q)^{alpha-k}
                           q^k exp(k(k-1)/(2 z^2))

    — the binomial-expansion bound of Wang et al. (2019), Thm 9 /
    Mironov et al.'s tight integer-order formula.  q=1 reduces to the
    plain Gaussian RDP."""
    if noise_multiplier <= 0:
        return math.inf
    if q <= 0:
        return 0.0
    if q >= 1.0:
        return rdp_gaussian(alpha, noise_multiplier)
    if alpha < 2 or alpha != int(alpha):
        raise ValueError(f"integer order >= 2 required, got {alpha}")
    alpha = int(alpha)
    z2 = noise_multiplier ** 2
    log_terms = [
        _log_comb(alpha, k)
        + (alpha - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + k * (k - 1) / (2.0 * z2)
        for k in range(alpha + 1)
    ]
    m = max(log_terms)
    log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return max(log_sum / (alpha - 1), 0.0)


def eps_from_rdp(orders: Sequence[float], rdp: Sequence[float],
                 delta: float) -> float:
    """(eps, delta)-DP from an RDP curve via the improved conversion
    (Balle et al. 2020 / Canonne-Kamath-Steinke form used by Opacus):

        eps = min_alpha rdp(alpha) + log((alpha-1)/alpha)
                         - (log delta + log alpha) / (alpha - 1)
    """
    if not 0 < delta < 1:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    best = math.inf
    for a, r in zip(orders, rdp):
        if math.isinf(r) or a <= 1:
            continue
        eps = (r + math.log((a - 1) / a)
               - (math.log(delta) + math.log(a)) / (a - 1))
        best = min(best, max(eps, 0.0))
    return best


@dataclasses.dataclass
class RDPAccountant:
    """Cumulative RDP over a round sequence.  ``step`` folds one round of
    the subsampled Gaussian mechanism; ``epsilon`` converts the running
    curve to the cumulative (eps, delta)."""

    orders: tuple[int, ...] = DEFAULT_ORDERS

    def __post_init__(self):
        self._rdp = [0.0] * len(self.orders)

    def step(self, noise_multiplier: float, q: float = 1.0,
             steps: int = 1) -> "RDPAccountant":
        for i, a in enumerate(self.orders):
            self._rdp[i] += steps * rdp_subsampled_gaussian(
                a, q, noise_multiplier)
        return self

    def epsilon(self, delta: float) -> float:
        return eps_from_rdp(self.orders, self._rdp, delta)


def ldp_noise_multiplier(ldp: bl.LDPConfig) -> float:
    """z = sigma / sensitivity for the repo's LDP mechanism: each clipped
    per-client update (L2 <= clip) is perturbed with
    sigma = gaussian_sigma(eps, delta, clip), so z = sigma / clip."""
    return bl.gaussian_sigma(ldp.eps, ldp.delta, ldp.clip) / ldp.clip


def ldp_cumulative_epsilon(ldp: Optional[bl.LDPConfig], rounds: int,
                           q: float = 1.0,
                           delta: Optional[float] = None
                           ) -> Optional[dict]:
    """Accountant state for a scenario cell: cumulative (eps, delta) of
    ``rounds`` compositions of the LDP mechanism at sampling rate ``q``
    (participation fraction or 1 - client_dropout).  None when the cell
    has no LDP stage — the scenario's accountant column is then empty."""
    if ldp is None:
        return None
    delta = ldp.delta if delta is None else delta
    z = ldp_noise_multiplier(ldp)
    acc = RDPAccountant().step(z, q=q, steps=rounds)
    return {
        "noise_multiplier": z,
        "per_round_eps": ldp.eps,
        "rounds": rounds,
        "q": q,
        "delta": delta,
        "eps": acc.epsilon(delta),
    }
