"""Metrics registry: counters, gauges and fixed-bucket latency histograms
with exact percentiles (a copy of ``repro/obs/metrics.py``, which is
stdlib-only; the port imports nothing of the JAX package).

`Histogram` keeps two views of one stream: fixed cumulative buckets
(Prometheus ``le`` semantics) for the text exposition, and the raw
samples, so ``percentile(q)`` is the exact nearest-rank order statistic,
not a bucket interpolation. Snapshots round-trip the samples (`snapshot`
/ `restore`). `MetricsRegistry` gives one JSON snapshot and one Prometheus
text exposition, byte for byte those of the reference for the same
operations.

No clock reads here: callers observe durations against their own
injected clocks (the `repro_torch.obs.clock` contract).
"""

from __future__ import annotations

import json
import math

# Prometheus-style latency buckets (seconds): sub-ms to minute-scale —
# from a cache hit to a 16k-vertex solve
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"),
)


def percentile(samples, q: float) -> float:
    """Exact nearest-rank percentile: the smallest sample with at least
    ``ceil(q·n)`` samples ≤ it. Empty input → 0.0 (the benches' "no
    completed requests" convention). ``q`` in [0, 1]."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q out of [0, 1]: {q}")
    xs = sorted(samples)
    if not xs:
        return 0.0
    rank = max(math.ceil(q * len(xs)), 1)
    return float(xs[min(rank, len(xs)) - 1])


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter decrement: {amount}")
        self.value += amount


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket cumulative histogram plus retained raw samples."""

    __slots__ = ("buckets", "bucket_counts", "count", "sum", "samples")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        buckets = tuple(float(b) for b in buckets)
        if list(buckets) != sorted(buckets) or not buckets:
            raise ValueError(f"buckets must be sorted, non-empty: {buckets}")
        if buckets[-1] != float("inf"):
            buckets = buckets + (float("inf"),)
        self.buckets = buckets
        self.bucket_counts = [0] * len(buckets)
        self.count = 0
        self.sum = 0.0
        self.samples: list[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.samples.append(value)
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.bucket_counts[i] += 1
                break

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def cumulative_counts(self) -> list[int]:
        """Prometheus ``le`` semantics: count of samples ≤ each bound."""
        out, running = [], 0
        for c in self.bucket_counts:
            running += c
            out.append(running)
        return out

    def summary(self) -> dict:
        """The compact JSON shape stats/bench rows embed: exact p50/p99
        plus count/sum — no raw samples (those belong to `snapshot`)."""
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "p50": round(self.percentile(0.5), 6),
            "p99": round(self.percentile(0.99), 6),
        }

    # ------------------------------------------------- checkpoint round-trip --
    def snapshot(self) -> dict:
        """Full JSON-able state; `restore` reproduces exact percentiles."""
        return {
            "buckets": ["inf" if math.isinf(b) else b for b in self.buckets],
            "samples": list(self.samples),
        }

    @classmethod
    def restore(cls, state: dict) -> "Histogram":
        h = cls(tuple(
            float("inf") if b == "inf" else float(b)
            for b in state["buckets"]
        ))
        for v in state["samples"]:
            h.observe(v)
        return h

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Histogram)
            and self.buckets == other.buckets
            and self.samples == other.samples
        )


class MetricsRegistry:
    """Named metrics with one JSON snapshot and one Prometheus text
    exposition. Names are dotted internally; the Prometheus view maps
    dots to underscores (its identifier grammar)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(buckets)
        return self._histograms[name]

    def attach_histogram(self, name: str, hist: Histogram) -> Histogram:
        """Register an externally owned histogram (e.g. the one living
        inside `ServiceStats`) so snapshots see the live object."""
        self._histograms[name] = hist
        return hist

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=1)

    @staticmethod
    def _prom_name(name: str) -> str:
        return name.replace(".", "_").replace("-", "_")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for k, c in sorted(self._counters.items()):
            n = self._prom_name(k)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value:g}")
        for k, g in sorted(self._gauges.items()):
            n = self._prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value:g}")
        for k, h in sorted(self._histograms.items()):
            n = self._prom_name(k)
            lines.append(f"# TYPE {n} histogram")
            for le, cum in zip(h.buckets, h.cumulative_counts()):
                bound = "+Inf" if math.isinf(le) else f"{le:g}"
                lines.append(f'{n}_bucket{{le="{bound}"}} {cum}')
            lines.append(f"{n}_sum {h.sum:g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"
