"""Performance Efficiency Index, paper §3.5 (copy of ``repro/core/pei.py``).

PEI = AR × EF × 100, where AR is the approximation ratio against an optimal
or best-known cut, and EF is a sigmoid over the runtime gap to a baseline —
EDP-inspired [Horowitz '94], bounded to (0, 1) with EF = 0.5 at parity.
"""

from __future__ import annotations

import dataclasses
import math


def approximation_ratio(cut_alg: float, cut_opt: float) -> float:
    if cut_opt <= 0:
        return 1.0 if cut_alg <= 0 else 0.0
    return float(cut_alg) / float(cut_opt)


def efficiency_factor(t_alg: float, t_base: float, alpha: float = 1e-3) -> float:
    # overflow-safe sigmoid
    x = alpha * (t_alg - t_base)
    if x >= 0:
        z = math.exp(-x)
        return z / (1.0 + z)
    z = math.exp(x)
    return 1.0 / (1.0 + z)


def pei(
    cut_alg: float,
    cut_opt: float,
    t_alg: float,
    t_base: float,
    alpha: float = 1e-3,
) -> float:
    return (
        approximation_ratio(cut_alg, cut_opt)
        * efficiency_factor(t_alg, t_base, alpha)
        * 100.0
    )


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Uniform result record for any Max-Cut solver (used by benchmarks)."""

    method: str
    n_vertices: int
    cut_value: float
    runtime_s: float
    extra: dict | None = None

    def ar(self, cut_opt: float) -> float:
        return approximation_ratio(self.cut_value, cut_opt)

    def pei(self, cut_opt: float, t_base: float, alpha: float = 1e-3) -> float:
        return pei(self.cut_value, cut_opt, self.runtime_s, t_base, alpha)
