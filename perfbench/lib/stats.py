"""Order statistics for the per-solve spread line (the arithmetic of the
solver's ``obs.metrics.percentile``, copied so that the yardstick stays
under the benchmark's own paths)."""

from __future__ import annotations

import math


def percentile(samples, q: float) -> float:
    """Exact nearest-rank percentile: the smallest sample with at least
    ceil(q·n) samples at or below it; ``q`` in [0, 1]."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q out of [0, 1]: {q}")
    xs = sorted(samples)
    if not xs:
        raise ValueError("no samples")
    rank = max(math.ceil(q * len(xs)), 1)
    return float(xs[min(rank, len(xs)) - 1])
