"""Max-Cut solve service (port of ``repro/service``): cross-request
batching over pluggable solver backends (single-device or `solve_pool`
over a `data` mesh), dispatch that does not wait for the card, per-tenant
fairness, SLA-driven knob selection with online recalibration, and a
canonical-graph result cache (docs/DESIGN.md §6)."""

from repro_torch.service.backend import LocalBackend, MeshBackend, make_backend
from repro_torch.service.cache import CacheStats, ResultCache
from repro_torch.service.canonical import CanonicalForm, canonical_form, canonical_key
from repro_torch.service.planner import (
    SLA,
    CalibrationStats,
    CostModel,
    KnobPlan,
    KnobTuple,
    Planner,
    ReplanDecision,
    quality_score,
)
from repro_torch.service.scheduler import (
    RequestResult,
    ServiceConfig,
    ServiceStats,
    SolveService,
    TenantStats,
    edge_capacity,
)
from repro_torch.service.workload import (
    Arrival,
    VirtualClock,
    arrival_trace,
    run_soak_virtual,
    run_soak_wall,
)

__all__ = [
    "LocalBackend",
    "MeshBackend",
    "make_backend",
    "CacheStats",
    "ResultCache",
    "CanonicalForm",
    "canonical_form",
    "canonical_key",
    "SLA",
    "CalibrationStats",
    "CostModel",
    "KnobPlan",
    "KnobTuple",
    "Planner",
    "ReplanDecision",
    "quality_score",
    "RequestResult",
    "ServiceConfig",
    "ServiceStats",
    "SolveService",
    "TenantStats",
    "edge_capacity",
    "Arrival",
    "VirtualClock",
    "arrival_trace",
    "run_soak_virtual",
    "run_soak_wall",
]
