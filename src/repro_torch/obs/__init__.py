"""Observability: span tracing, metrics and the build ledger (port of
``repro/obs``).

No module here reads a wall clock except `repro_torch.obs.clock`:

  - `trace`   — `Tracer` / `Span`: nested spans over the solve's stages,
    JSON-lines and Chrome trace export.
  - `metrics` — `MetricsRegistry`, `Counter` / `Gauge` / `Histogram`,
    exact nearest-rank `percentile`; JSON and Prometheus exposition.
  - `ledger`  — `CompileLedger`: every CUDA source built or loaded, and
    every kernel dispatch.

`validate` holds the trace and metrics schema validators
(``python -m repro_torch.obs.validate``).
"""

from repro_torch.obs.clock import default_clock
from repro_torch.obs.ledger import CompileLedger, LedgerEvent, get_ledger
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from repro_torch.obs.trace import Span, Tracer, get_tracer, set_tracer, use_tracer

__all__ = [
    "DEFAULT_BUCKETS",
    "CompileLedger",
    "Counter",
    "Gauge",
    "Histogram",
    "LedgerEvent",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "default_clock",
    "get_ledger",
    "get_tracer",
    "percentile",
    "set_tracer",
    "use_tracer",
]
