"""Cross-request batching Max-Cut solve service (port of
``repro/service/scheduler.py``; docs/DESIGN.md §6.1, §6.5, §6.6).

The paper's pipeline solves one problem per invocation; the service
amortizes solver capacity *across* requests:

  1. `submit` places a request on the admission queue. Admission consults
     the result cache on the canonical graph hash, and — on a miss — asks
     the SLA planner for a knob tuple, partitions via
     `core.partition.partition_for_solver` at the chosen qubit budget, and
     enqueues one work item per subgraph;
  2. the dispatcher packs pending subgraphs from *any* request (and any
     tenant) into fixed-shape batches for the configured solver backend:
     `qaoa.solve_subgraph_batch` on one device, or
     `core.distributed.solve_pool` over a `data` mesh. Batches are
     shape-bucketed by the QAOA config: every dispatch in a bucket uses
     exactly ``batch_slots`` rows padded to the qubit budget's edge
     capacity N·(N−1)/2 — the maximum a ≤N-vertex subgraph can carry.
     Dispatch does not wait for the card: the inputs go up from pinned
     host memory without a stream sync, and nothing on the solve path
     reads the card back, so up to ``max_inflight`` batches are queued
     while admission goes on, and the loop blocks only when it harvests
     the oldest in-flight batch. Everything stays a deterministic
     single-thread event loop — "concurrent" means many admitted requests
     and in-flight batches, never racing threads;
  3. per-request completion tracking (a remaining-subgraph count) fires
     the merge the moment a request's last candidate lands: the default
     path runs `core.paraqaoa.merge_candidates` — the *same* merge
     `core.solve` runs, on the same device, which together with the
     per-row bit-stability of the batched solver makes service cuts
     bit-identical to solo `solve` runs on the same knobs — while
     streaming requests run the anytime `core.merge.merge_stream` and
     surface the best-known cut after every merge level. On the card the
     merge runs on a stream of its own, so its reads of the card wait
     for the merge alone and not for the batches still in flight.

Multi-tenant fairness: when a bucket holds more waiting subgraphs than
one dispatch can take, slots are filled round-robin across tenants
(optionally capped per tenant under contention), and any bucket whose
oldest item has waited ``max_wait_dispatches`` dispatches pre-empts the
fullest-bucket heuristic — so no request starves behind a heavier
tenant's traffic.

Served-request stage timings stream back into the planner's cost model
(`Planner.observe_*`) so knob selection tracks the hardware the service
actually runs on.

Deadline enforcement: every clock read goes through one injected time
source (``SolveService(clock=...)``, default `time.perf_counter` — a
`workload.VirtualClock` makes whole soaks bit-deterministic). A request's
deadline becomes an absolute clock stamp at submission; admission plans
against the *residual* budget and sheds outright when even the floor plan
(`Planner.floor_predicted`) is predicted late. Each `pump` tick then
re-scores queued-but-undispatched requests against their remaining
budget with the live (recalibrated) cost model: `Planner.replan` keeps,
downgrades (re-partition at the cheaper knobs — never below the request's
declared `SLA.floor_quality`), or clamps to the floor plan. Once
admitted, a request is never shed on a prediction alone; it is dropped
(terminal state ``"expired"``) only when its deadline has actually passed
before any of its subgraphs dispatched. Every request therefore reaches
exactly one terminal state — completed / shed / expired — and
`ServiceStats` carries exact per-tenant attainment, shed, and downgrade
accounting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import paraqaoa as para_mod
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.graph import Graph, Problem, as_problem, problem_value
from repro_torch.core.partition import partition_for_solver, split_linear
from repro_torch.device import resolve_device
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import Span, Tracer
from repro_torch.service.backend import make_backend
from repro_torch.service.cache import ResultCache
from repro_torch.service.canonical import canonical_form
from repro_torch.service.planner import SLA, KnobPlan, Planner, quality_score


def edge_capacity(n_qubits: int) -> int:
    """Max simple-edge count of a subgraph that fits an N-qubit solver."""
    return max(n_qubits * (n_qubits - 1) // 2, 1)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    batch_slots: int = 16  # fixed rows per solver dispatch (one shape/bucket)
    cache_capacity: int = 256
    enable_cache: bool = True
    max_qubits: int = 12  # hardware budget cap handed to the planner
    anytime_min_levels: int = 2  # stream only when the merge has >1 level
    # §6.5 backend: None → single-device program; a mesh spec (string /
    # dict / Mesh) routes batches through solve_pool over its data axes
    mesh: object = None
    # §6.5 async admission loop
    max_inflight: int = 2  # dispatched-but-unharvested batches
    max_wait_dispatches: int = 4  # anti-starvation pre-emption bound
    tenant_max_slots: int | None = None  # per-tenant slot cap under contention
    # §6.5 online recalibration: stream stage timings into the planner
    recalibrate: bool = True
    # §6.6 wall-clock SLA enforcement: shed predicted-late requests at
    # admission, re-score queued requests every tick (downgrade toward
    # the accuracy floor), and expire requests whose deadline passes
    # before dispatch. Off = the pre-§6.6 load-driven behavior (the
    # throughput-parity benches pin it off: a shed request has no cut to
    # compare)
    enforce_deadlines: bool = True
    # where the batches run: "cuda" (default; raises without a GPU) or
    # "cpu" for the plain PyTorch versions
    device: str = "cuda"


@dataclasses.dataclass
class RequestResult:
    request_id: int
    assignment: np.ndarray  # None for shed/expired requests
    cut_value: float  # nan for shed/expired requests
    cached: bool
    plan: KnobPlan
    latency_s: float
    timings: dict
    anytime: list  # [(level, n_levels, best_known_cut)] for streamed requests
    tenant: str = "default"
    dispatches_waited: int = 0  # dispatches between admission and completion
    # §6.6 terminal state: "completed" | "shed" | "expired" — exactly one
    # per submitted request
    status: str = "completed"
    # None for undeadlined requests; else whether the deadline was met
    # (False for shed/expired)
    deadline_met: bool | None = None
    downgrades: int = 0  # deadline re-plans applied before completion


class _Request:
    def __init__(self, rid, prob, sla, plan, cfg, stream, on_update, form,
                 tenant, submit_t, deadline_t=None):
        self.id = rid
        self.prob = prob  # the full Problem (graph + linear + offset)
        self.graph = prob.graph
        self.has_lin = prob.has_linear
        self.sub_lins = None  # per-subgraph linear terms, when has_lin
        self.sla = sla
        self.plan = plan
        self.cfg = cfg  # ParaQAOAConfig derived from plan.knobs
        self.stream = stream
        self.on_update = on_update
        self.form = form  # canonical form, when the cache is enabled
        self.tenant = tenant
        self.submit_t = submit_t
        self.deadline_t = deadline_t  # absolute clock stamp, or None
        self.part = None
        self.bit_indices = None  # (M, K) int64
        self.remaining = 0
        self.solve_done_t = None
        self.admit_dispatch = 0  # stats.dispatches at admission
        self.started = False  # any subgraph dispatched (re-plan barrier)
        self.downgrades = 0  # §6.6 deadline re-plans applied


class _Item:
    """One queued subgraph: request, its subgraph index, enqueue stamp."""

    __slots__ = ("req", "idx", "enq_dispatch")

    def __init__(self, req, idx, enq_dispatch):
        self.req = req
        self.idx = idx
        self.enq_dispatch = enq_dispatch


class _Batch:
    """One dispatched (possibly still in-flight) solver batch."""

    __slots__ = ("qcfg", "items", "result", "t_issue", "span")

    def __init__(self, qcfg, items, result, t_issue, span=None):
        self.qcfg = qcfg
        self.items = items
        self.result = result  # device tensors, possibly still being computed
        self.t_issue = t_issue
        self.span = span  # §8 dispatch span, open until harvest


class _SLACounters:
    """§6.6 terminal-state + attainment accounting, shared by the global
    and per-tenant stats so the two cannot drift apart structurally.

    Every submitted request lands in exactly one terminal bucket —
    ``completed`` / ``shed`` / ``expired`` — so attainment denominators
    are exact (the latent pre-§6.6 gap: stats were recorded only for
    completed requests). Among *deadlined* requests, ``sla_met`` /
    ``sla_missed`` split the completed bucket; undeadlined completions
    count in neither. Attainment is met-over-all-deadlined — shed and
    expired requests count against it.
    """

    @property
    def terminal(self) -> int:
        return self.completed + self.shed + self.expired

    @property
    def deadlined(self) -> int:
        return self.sla_met + self.sla_missed + self.shed + self.expired

    @property
    def attainment(self) -> float:
        d = self.deadlined
        return self.sla_met / d if d else 1.0


def _counter_fields(obj) -> list[str]:
    """The plain-count dataclass fields of a stats object — everything
    except the latency `Histogram` and the per-tenant sub-dict."""
    return [
        f.name for f in dataclasses.fields(obj)
        if f.name not in ("latency", "tenants")
    ]


@dataclasses.dataclass
class TenantStats(_SLACounters):
    submitted: int = 0
    completed: int = 0
    cache_served: int = 0
    slots: int = 0  # solver slots this tenant's subgraphs occupied
    shed: int = 0  # predicted-late at admission, never enqueued
    expired: int = 0  # deadline passed while queued, dropped
    downgraded: int = 0  # completed after >= 1 deadline re-plan
    sla_met: int = 0  # completed within the deadline
    sla_missed: int = 0  # completed, but late
    # §8: completed-request latency distribution (exact p50/p99) — lives
    # in the stats object itself so benches and exports stop
    # reconstructing it from the results dict
    latency: Histogram = dataclasses.field(default_factory=Histogram)

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in _counter_fields(self)}
        d["latency"] = self.latency.summary()
        d["attainment"] = round(self.attainment, 4)
        return d

    # §8: checkpoint-style round-trip — the histogram's raw samples
    # travel with the counters, so restored stats keep exact percentiles
    def snapshot(self) -> dict:
        d = {f: getattr(self, f) for f in _counter_fields(self)}
        d["latency"] = self.latency.snapshot()
        return d

    @classmethod
    def restore(cls, state: dict) -> "TenantStats":
        ts = cls(**{f: state[f] for f in state if f != "latency"})
        ts.latency = Histogram.restore(state["latency"])
        return ts


@dataclasses.dataclass
class ServiceStats(_SLACounters):
    dispatches: int = 0
    slots_total: int = 0
    slots_filled: int = 0
    completed: int = 0
    cache_served: int = 0
    admitted: int = 0
    preemptions: int = 0  # anti-starvation bucket picks
    max_inflight_seen: int = 0
    shed: int = 0
    expired: int = 0
    downgraded: int = 0  # requests completed after >= 1 downgrade
    downgrade_events: int = 0  # individual deadline re-plans applied
    sla_met: int = 0
    sla_missed: int = 0
    latency: Histogram = dataclasses.field(default_factory=Histogram)
    tenants: dict = dataclasses.field(default_factory=dict)

    def tenant(self, name: str) -> TenantStats:
        if name not in self.tenants:
            self.tenants[name] = TenantStats()
        return self.tenants[name]

    @property
    def fill_ratio(self) -> float:
        return self.slots_filled / self.slots_total if self.slots_total else 0.0

    def as_dict(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "slots_total": self.slots_total,
            "slots_filled": self.slots_filled,
            "fill_ratio": round(self.fill_ratio, 4),
            "completed": self.completed,
            "cache_served": self.cache_served,
            "admitted": self.admitted,
            "preemptions": self.preemptions,
            "max_inflight_seen": self.max_inflight_seen,
            "shed": self.shed,
            "expired": self.expired,
            "downgraded": self.downgraded,
            "downgrade_events": self.downgrade_events,
            "sla_met": self.sla_met,
            "sla_missed": self.sla_missed,
            "latency": self.latency.summary(),
            "attainment": round(self.attainment, 4),
            "tenants": {t: s.as_dict() for t, s in self.tenants.items()},
        }

    def snapshot(self) -> dict:
        d = {f: getattr(self, f) for f in _counter_fields(self)}
        d["latency"] = self.latency.snapshot()
        d["tenants"] = {t: s.snapshot() for t, s in self.tenants.items()}
        return d

    @classmethod
    def restore(cls, state: dict) -> "ServiceStats":
        s = cls(**{
            f: state[f] for f in state if f not in ("latency", "tenants")
        })
        s.latency = Histogram.restore(state["latency"])
        s.tenants = {
            t: TenantStats.restore(ts) for t, ts in state["tenants"].items()
        }
        return s


class SolveService:
    """Batched Max-Cut solve service over the ParaQAOA pipeline."""

    def __init__(
        self,
        config: ServiceConfig = ServiceConfig(),
        planner: Planner | None = None,
        cache: ResultCache | None = None,
        backend=None,
        clock: Callable[[], float] | None = None,
        tracer: Tracer | None = None,
    ):
        self.config = config
        self.device = resolve_device(config.device)
        # the merge's own stream on the card: its reads wait for the merge,
        # not for the batches in flight on the current stream
        self._merge_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        # §6.6: the single time source every deadline decision and every
        # latency/observability stamp reads. Injecting a
        # `workload.VirtualClock` makes a whole soak bit-deterministic;
        # the default is the same monotonic clock as before
        self._clock = clock if clock is not None else time.perf_counter
        # §8: the span tracer every lifecycle/stage stamp goes through.
        # The default records nothing (tracing off); a driver passing its
        # own `Tracer(record=True)` must construct it over this same
        # clock or span nesting/determinism guarantees break
        self.trace = tracer if tracer is not None else Tracer(
            clock=self._clock
        )
        # open per-request root spans: rid → Span, ended exactly once at
        # the request's terminal state (completed / shed / expired)
        self._req_spans: dict[int, Span] = {}
        self.planner = planner or Planner(
            max_qubits=config.max_qubits, batch_slots=config.batch_slots
        )
        self.cache = cache or ResultCache(config.cache_capacity)
        self.backend = backend or make_backend(config.mesh, self.device)
        # a backend that graphs its buckets captures every one the grid can
        # reach now: a capture synchronises the card, so no dispatch makes one
        prepare = getattr(self.backend, "prepare", None)
        if prepare is not None:
            prepare(self._grid_buckets(), config.batch_slots)
        self.stats = ServiceStats()
        self.results: "OrderedDict[int, RequestResult]" = OrderedDict()
        self._next_id = 0
        self._active: dict[int, _Request] = {}
        # admission queue: submitted-but-not-admitted requests, drained by
        # `submit` (eager default) or at the top of every `pump` tick
        self._admission: deque = deque()
        # bucket key: (frozen QAOAConfig, has-linear-terms) — one queue per
        # static solver configuration; linear (QUBO/MIS) batches carry a
        # 4th input array, so they never share a batch with pure Max-Cut
        self._buckets: "OrderedDict[tuple, deque]" = OrderedDict()
        # dispatched batches whose device results have not landed yet
        self._inflight: "deque[_Batch]" = deque()
        self._last_harvest_t = 0.0  # de-queues solve-time observations
        # in-flight dedup: canonical key → (primary request id, its quality);
        # isomorphic requests admitted while their twin is still solving
        # coalesce onto it and are served from cache when it completes
        self._inflight_forms: dict[str, tuple[int, float]] = {}
        self._followers: dict[str, list] = {}

    def _grid_buckets(self) -> list:
        """(`QAOAConfig`, padded edges a row, linear terms or not) of every
        bucket a plan of the planner's grid can fill, in the grid's order."""
        cfgs = dict.fromkeys(
            para_mod.ParaQAOAConfig(n_qubits=kn.n_qubits, top_k=kn.top_k,
                                    p_layers=kn.p_layers, opt_steps=kn.opt_steps,
                                    beam_width=kn.beam_width).qaoa_config()
            for kn in self.planner.grid)
        return [(q, edge_capacity(q.n_qubits), lin) for q in cfgs for lin in (False, True)]

    # ------------------------------------------------------------- admit --
    def submit(
        self,
        graph: Graph | Problem,
        sla: SLA = SLA(),
        stream: bool = False,
        on_update: Optional[Callable] = None,
        tenant: str = "default",
        defer: bool = False,
    ) -> int:
        """Place one solve request on the admission queue; returns its id.

        ``graph`` may be a plain `Graph` (Max-Cut) or a `core.graph.Problem`
        (weighted Max-Cut / QUBO / MIS): linear terms ride through the
        shape buckets (keyed on (config, has-linear)), the backend dispatch, and the merge; the result's
        ``cut_value`` is the full objective including the constant offset.

        With ``defer=False`` (default) admission happens before `submit`
        returns: cache hits complete immediately (the result is visible
        in `results` on return); misses enqueue the request's subgraphs
        into the shared batch queues. ``defer=True`` guarantees only
        that *this call* does no admission work — the request waits on
        the admission queue until the next `pump` tick or the next eager
        `submit`, whichever drains the (strictly FIFO) queue first; the
        interleaved-arrival shape of a live frontend, where requests
        land while earlier batches are still in flight. Either way, call
        `pump`/`drain` to make progress.
        """
        rid = self._next_id
        self._next_id += 1
        self.stats.tenant(tenant).submitted += 1
        # §8: the request's root span opens at submission and closes at
        # its terminal state — parentless even when submitted from
        # inside another request's streaming callback
        self._req_spans[rid] = self.trace.begin(
            "request", parent=trace_mod.ROOT, rid=rid, tenant=tenant
        )
        self._admission.append(
            (rid, graph, sla, stream, on_update, tenant, self._clock())
        )
        if not defer:
            self._process_admissions()
        return rid

    def _budget(self, sla: SLA, t0: float, now: float) -> float | None:
        """Residual wall-clock budget, or None for undeadlined requests."""
        if sla.deadline_s is None:
            return None
        return t0 + sla.deadline_s - now

    def _process_admissions(self) -> None:
        while self._admission:
            rid, graph, sla, stream, on_update, tenant, t0 = (
                self._admission.popleft()
            )
            prob = as_problem(graph)
            graph = prob.graph
            self.stats.admitted += 1
            # §6.6: plan against the budget *remaining now* — a deferred
            # request that waited on the admission queue plans (and is
            # shed-checked) at its shrunken residual deadline
            now = self._clock()
            budget = self._budget(sla, t0, now)
            eff_sla = sla if budget is None else dataclasses.replace(
                sla, deadline_s=max(budget, 0.0)
            )
            # §8: the admission span covers plan + cache lookup and is
            # closed *before* any terminal verdict is recorded, so a
            # cache-hit/shed root span never ends inside a still-open
            # child
            root = self._req_spans.get(rid)
            adm = self.trace.begin("admission", parent=root)
            with self.trace.attach(adm):
                with self.trace.span("plan"):
                    plan = self.planner.plan(graph.n, graph.n_edges, eff_sla)
                form = None
                hit = None
                if self.config.enable_cache:
                    form = canonical_form(prob)
                    with self.trace.span("cache_lookup"):
                        hit = self.cache.lookup(
                            prob, form=form, min_quality=plan.quality
                        )
            self.trace.end(adm, cache_hit=hit is not None)
            if hit is not None:
                assignment, cut = hit
                self._record_cached(
                    rid, prob, plan, assignment, cut, t0,
                    stream=stream, on_update=on_update, tenant=tenant,
                    deadline_t=None if sla.deadline_s is None
                    else t0 + sla.deadline_s,
                )
                continue
            # shed verdict before any work is enqueued (but after the
            # cache: a hit completes instantly, predicted-late or not)
            if self._shed_if_floor_late(rid, graph, sla, plan, budget, t0,
                                        tenant):
                continue
            if form is not None:
                # coalesce onto an in-flight isomorphic twin of sufficient
                # quality: no work enqueued; served from cache at its merge.
                # Streaming requests bypass dedup — they want per-level
                # updates.
                primary = self._inflight_forms.get(form.key)
                if primary is not None and primary[1] >= plan.quality and not stream:
                    self._followers.setdefault(form.key, []).append(
                        (rid, prob, sla, plan, form, t0, tenant)
                    )
                    continue

            self._admit(rid, prob, sla, plan, form, stream, on_update,
                        tenant, t0)

    def _shed_if_floor_late(self, rid, graph, sla, plan, budget, t0,
                            tenant) -> bool:
        """§6.6 admission verdict: True (and a recorded ``"shed"``
        terminal) when even the floor plan is predicted to miss the
        residual budget."""
        if (not self.config.enforce_deadlines) or budget is None:
            return False
        graph = as_problem(graph).graph
        floor = self.planner.floor_predicted(
            graph.n, graph.n_edges, sla.floor_quality
        )
        floor_s = floor[1].total_s if floor is not None else float("inf")
        if floor_s <= budget:
            return False
        self._record_dropped(rid, plan, t0, tenant, "shed",
                             predicted_floor_s=floor_s, budget_s=budget)
        return True

    def _admit(self, rid, graph, sla, plan, form, stream, on_update,
               tenant="default", t0=None) -> None:
        """Enqueue a request's subgraphs into its shape bucket."""
        prob = as_problem(graph)
        kn = plan.knobs
        cfg = plan.to_config()
        if t0 is None:
            t0 = self._clock()
        deadline_t = None if sla.deadline_s is None else t0 + sla.deadline_s
        req = _Request(rid, prob, sla, plan, cfg, stream, on_update, form,
                       tenant, t0, deadline_t)
        graph = req.graph
        ps = self.trace.begin(
            "partition", parent=self._req_spans.get(rid),
            n=graph.n, n_edges=graph.n_edges, n_qubits=kn.n_qubits,
        )
        req.part = partition_for_solver(graph, kn.n_qubits)
        if req.has_lin:
            req.sub_lins = split_linear(req.part, prob.linear)
        self.trace.end(ps, m=req.part.m)
        self._observe(ps)
        req.bit_indices = np.zeros((req.part.m, kn.top_k), dtype=np.int64)
        req.remaining = req.part.m
        req.admit_dispatch = self.stats.dispatches
        self._active[rid] = req
        if form is not None and form.key not in self._inflight_forms:
            self._inflight_forms[form.key] = (rid, plan.quality)

        queue = self._buckets.setdefault((cfg.qaoa_config(), req.has_lin),
                                         deque())
        for idx in range(req.part.m):
            queue.append(_Item(req, idx, self.stats.dispatches))

    def _record_cached(
        self, rid, graph, plan, assignment, cut, t0,
        stream=False, on_update=None, tenant="default", deadline_t=None,
    ) -> None:
        # a streamed request served from cache still gets its anytime
        # contract: one final update (the answer is complete immediately)
        anytime = [(1, 1, cut)] if stream else []
        if stream and on_update is not None:
            on_update(rid, 1, 1, cut)
        now = self._clock()
        met = None if deadline_t is None else bool(now <= deadline_t)
        self.results[rid] = RequestResult(
            request_id=rid,
            assignment=assignment,
            cut_value=cut,
            cached=True,
            plan=plan,
            latency_s=now - t0,
            timings={"cache_s": now - t0},
            anytime=anytime,
            tenant=tenant,
            deadline_met=met,
        )
        self.stats.completed += 1
        self.stats.cache_served += 1
        ts = self.stats.tenant(tenant)
        ts.completed += 1
        ts.cache_served += 1
        self._count_deadline(met, ts)
        self.stats.latency.observe(now - t0)
        ts.latency.observe(now - t0)
        self._end_request_span(rid, "completed", cached=True)

    def _count_deadline(self, met: bool | None, ts: TenantStats) -> None:
        if met is None:
            return
        field = "sla_met" if met else "sla_missed"
        setattr(self.stats, field, getattr(self.stats, field) + 1)
        setattr(ts, field, getattr(ts, field) + 1)

    def _record_dropped(self, rid, plan, t0, tenant, status, *,
                        predicted_floor_s=None, budget_s=None) -> None:
        """§6.6 non-served terminal states: ``"shed"`` (admission verdict
        — even the floor plan predicted late) and ``"expired"`` (deadline
        passed while queued). The recorded timings carry the verdict's
        evidence so tests can assert shed ⇒ floor-predicted-late."""
        now = self._clock()
        timings = {"verdict_s": now - t0}
        if predicted_floor_s is not None:
            timings["predicted_floor_s"] = predicted_floor_s
            timings["budget_s"] = budget_s
        self.results[rid] = RequestResult(
            request_id=rid,
            assignment=None,
            cut_value=float("nan"),
            cached=False,
            plan=plan,
            latency_s=now - t0,
            timings=timings,
            anytime=[],
            tenant=tenant,
            status=status,
            deadline_met=False,
        )
        ts = self.stats.tenant(tenant)
        setattr(self.stats, status, getattr(self.stats, status) + 1)
        setattr(ts, status, getattr(ts, status) + 1)
        self._end_request_span(rid, status)

    def _end_request_span(self, rid: int, status: str, **attrs) -> None:
        """§8: close the request's root span at its terminal state — the
        pop guarantees exactly one terminal span per submitted request
        (the reconciliation invariant of the trace)."""
        root = self._req_spans.pop(rid, None)
        if root is not None:
            self.trace.end(root, status=status, **attrs)

    def _observe(self, span: Span) -> None:
        """§6.5 recalibration via the §8 span stream: stage spans carry
        their observation payload in their attrs, and the planner's
        `observe_span` dispatches on the span name. Duck-typed planners
        without `observe_span` fall back to the legacy per-stage hooks."""
        if not self.config.recalibrate:
            return
        observe = getattr(self.planner, "observe_span", None)
        if observe is not None:
            observe(span)
            return
        a = span.attrs
        if span.name == "partition":
            fn = getattr(self.planner, "observe_partition", None)
            if fn is not None:
                fn(a["n"], a["n_edges"], span.duration_s)
        elif span.name == "solve":
            fn = getattr(self.planner, "observe_solve", None)
            if fn is not None:
                fn(a["n_qubits"], a["p_layers"], a["opt_steps"], a["slots"],
                   span.duration_s)
        elif span.name == "merge":
            fn = getattr(self.planner, "observe_merge", None)
            if fn is not None:
                fn(a["knobs"], a["m"], a["n_edges"], span.duration_s)

    # --------------------------------------------------------- dispatch --
    def _pick_bucket(self):
        """The bucket to dispatch next: the fullest — unless some queue's
        head item has waited ``max_wait_dispatches`` dispatches, in which
        case the queue with the oldest head pre-empts (the bounded-delay
        guarantee of DESIGN.md §6.5)."""
        live = [(key, q) for key, q in self._buckets.items() if q]
        if not live:
            return None
        fullest = max(live, key=lambda b: len(b[1]))
        bound = self.config.max_wait_dispatches
        overdue = [
            (key, q) for key, q in live
            if self.stats.dispatches - q[0].enq_dispatch >= bound
        ]
        if overdue:
            choice = min(overdue, key=lambda b: b[1][0].enq_dispatch)
            if choice[0] is not fullest[0]:  # an actual pre-emption, not
                self.stats.preemptions += 1  # the pick it would get anyway
            return choice
        return fullest

    def _take_items(self, queue: deque) -> list:
        """Pop up to ``batch_slots`` items, round-robin across tenants.

        With a single tenant (or a queue that fits one dispatch) this is
        plain FIFO. Under contention, slots interleave tenants in
        arrival order of each tenant's oldest item, optionally capped at
        ``tenant_max_slots`` per tenant so one heavy tenant cannot fill
        the whole dispatch while others wait. The quota is
        work-conserving: once every tenant with queued items has had its
        capped share, leftover slots fill round-robin anyway — padding
        rows cost the same as filled ones, so idling capacity would only
        delay the capped tenant without helping anyone.
        """
        slots = self.config.batch_slots
        if len(queue) <= slots:
            items = list(queue)
            queue.clear()
            return items
        by_tenant: "OrderedDict[str, deque]" = OrderedDict()
        for it in queue:
            by_tenant.setdefault(it.req.tenant, deque()).append(it)
        cap = self.config.tenant_max_slots
        if cap is None or len(by_tenant) <= 1:
            cap = slots
        cap = max(cap, 1)  # a 0/negative quota must still make progress
        picked, taken = [], {t: 0 for t in by_tenant}
        while len(picked) < slots and by_tenant:
            progressed = False
            for t in list(by_tenant):
                if len(picked) == slots:
                    break
                if taken[t] >= cap:
                    continue
                picked.append(by_tenant[t].popleft())
                taken[t] += 1
                progressed = True
                if not by_tenant[t]:
                    del by_tenant[t]
            if not progressed:
                # every waiting tenant got its capped share: fill the
                # leftover slots rather than dispatch empty rows
                cap = slots
        chosen = set(map(id, picked))
        remaining = [it for it in queue if id(it) not in chosen]
        queue.clear()
        queue.extend(remaining)
        return picked

    def _dispatch_one(self) -> bool:
        """Issue one cross-request batch to the backend (non-blocking)."""
        bucket = self._pick_bucket()
        if bucket is None:
            return False
        (qcfg, has_lin), queue = bucket
        slots = self.config.batch_slots
        items = self._take_items(queue)

        edges, weights, masks = qaoa_mod.pad_subgraph_arrays(
            [it.req.part.subgraphs[it.idx] for it in items],
            qcfg.n_qubits,
            e_pad=edge_capacity(qcfg.n_qubits),
            n_rows=slots,
            device=self.device,
        )
        linears = None
        if has_lin:
            linears = qaoa_mod.pad_linear_arrays(
                [it.req.sub_lins[it.idx] for it in items],
                qcfg.n_qubits,
                n_rows=slots,
                device=self.device,
            )
        # §8: one dispatch span per issued batch, open until its harvest
        # (requests it carries are listed in attrs — batches cross
        # request and tenant boundaries, so the span cannot nest under
        # any single request root)
        ds = self.trace.begin(
            "dispatch", parent=trace_mod.ROOT,
            n_qubits=qcfg.n_qubits, slots=slots, filled=len(items),
            rids=sorted({it.req.id for it in items}),
        )
        res = self.backend.solve_batch(qcfg, edges, weights, masks,
                                       linears=linears)
        self._inflight.append(_Batch(qcfg, items, res, self._clock(), ds))
        for it in items:
            it.req.started = True  # §6.6: committed — no more re-plans

        self.stats.dispatches += 1
        self.stats.slots_total += slots
        self.stats.slots_filled += len(items)
        self.stats.max_inflight_seen = max(
            self.stats.max_inflight_seen, len(self._inflight)
        )
        for it in items:
            self.stats.tenant(it.req.tenant).slots += 1
        return True

    def _harvest_one(self) -> None:
        """Land the oldest in-flight batch (blocks) and run any merges it
        unblocks."""
        batch = self._inflight.popleft()
        bitstrings = batch.result.bitstrings.cpu().numpy()  # blocks here
        t_land = self._clock()
        # §8: the solve span is retroactive — the device runs batches
        # serially, so this batch's compute window starts when the
        # previous harvest ended, not at issue time, which would bill it
        # for the whole in-flight queue ahead of it and inflate c_solve
        # ~max_inflight-fold
        t_start = max(batch.t_issue, self._last_harvest_t)
        solve_span = self.trace.span_at(
            "solve", t_start, t_land, parent=batch.span,
            n_qubits=batch.qcfg.n_qubits, p_layers=batch.qcfg.p_layers,
            opt_steps=batch.qcfg.opt_steps, slots=self.config.batch_slots,
        )
        self._observe(solve_span)
        if batch.span is not None:
            self.trace.end(batch.span)
        self._last_harvest_t = t_land

        done_requests = []
        for slot, it in enumerate(batch.items):
            it.req.bit_indices[it.idx] = bitstrings[slot]
            it.req.remaining -= 1
            if it.req.remaining == 0:
                done_requests.append(it.req)
        for req in done_requests:
            req.solve_done_t = self._clock()
            self._merge(req)

    # --------------------------------------------------- §6.6 re-scoring --
    def _rescore_queued(self) -> None:
        """§6.6: one deadline pass over queued-but-undispatched requests.

        Expired deadlines drop the request (terminal ``"expired"``);
        otherwise `Planner.replan` re-scores the residual budget against
        the live (possibly recalibrated) cost model — keep, downgrade to
        the cheapest floor-meeting plan, or — on a shed verdict for an
        *already admitted* request — clamp to the floor plan instead of
        shedding: predictions drift with recalibration, so admission is
        the only place a prediction alone may reject work.
        Requests with any subgraph dispatched are committed (work would
        be discarded) and complete at their admitted knobs.
        """
        if not self.config.enforce_deadlines:
            return
        now = self._clock()
        for req in list(self._active.values()):
            if req.deadline_t is None or req.started:
                continue
            budget = req.deadline_t - now
            if budget <= 0.0:
                self._expire(req)
                continue
            decision = self.planner.replan(
                req.graph.n, req.graph.n_edges, budget, req.plan,
                floor_quality=req.sla.floor_quality,
            )
            if decision.verdict == "keep":
                continue
            if decision.verdict == "downgrade":
                self._apply_downgrade(req, decision.plan)
                continue
            # shed verdict post-admission: clamp to the floor plan (the
            # cheapest floor-meeting tuple) rather than retroactively shed
            floor = self.planner.floor_predicted(
                req.graph.n, req.graph.n_edges, req.sla.floor_quality
            )
            if floor is not None and floor[0] != req.plan.knobs:
                kn, pred = floor
                plan = KnobPlan(
                    knobs=kn,
                    merge_level=req.plan.merge_level,
                    predicted=pred,
                    quality=quality_score(kn),
                    meets_deadline=False,
                    meets_quality=req.sla.floor_quality is None
                    or quality_score(kn) >= req.sla.floor_quality - 1e-12,
                )
                self._apply_downgrade(req, plan)

    def _apply_downgrade(self, req: _Request, plan: KnobPlan) -> None:
        """Re-plan one queued request to cheaper knobs: pull its items
        from the old shape bucket, re-partition at the new qubit budget,
        and enqueue into the new bucket. Only legal before any of its
        subgraphs dispatched (`req.started` guards)."""
        old_key = (req.cfg.qaoa_config(), req.has_lin)
        queue = self._buckets.get(old_key)
        if queue is not None:
            keep = [it for it in queue if it.req is not req]
            queue.clear()
            queue.extend(keep)
        req.plan = plan
        req.cfg = plan.to_config()
        req.part = partition_for_solver(req.graph, plan.knobs.n_qubits)
        if req.has_lin:
            # re-partitioning moves range boundaries: the per-subgraph
            # linear split must follow the new first-coverage assignment
            req.sub_lins = split_linear(req.part, req.prob.linear)
        req.bit_indices = np.zeros(
            (req.part.m, plan.knobs.top_k), dtype=np.int64
        )
        req.remaining = req.part.m
        req.downgrades += 1
        self.stats.downgrade_events += 1
        # §8: a replan is an instant event — a zero-width span marks it
        # in the request's tree with the knobs it moved to
        t = self._clock()
        self.trace.span_at(
            "replan", t, t, parent=self._req_spans.get(req.id),
            verdict="downgrade", n_qubits=plan.knobs.n_qubits,
            m=req.part.m,
        )
        # new twins must not coalesce onto a primary that now plans
        # cheaper than they require
        if req.form is not None:
            primary = self._inflight_forms.get(req.form.key)
            if primary is not None and primary[0] == req.id:
                self._inflight_forms[req.form.key] = (req.id, plan.quality)
        new_queue = self._buckets.setdefault(
            (req.cfg.qaoa_config(), req.has_lin), deque()
        )
        for idx in range(req.part.m):
            new_queue.append(_Item(req, idx, self.stats.dispatches))

    def _expire(self, req: _Request) -> None:
        """Drop one queued request whose deadline passed before dispatch
        (terminal ``"expired"``), and release its coalesced followers
        back through admission-style re-scoring."""
        queue = self._buckets.get((req.cfg.qaoa_config(), req.has_lin))
        if queue is not None:
            keep = [it for it in queue if it.req is not req]
            queue.clear()
            queue.extend(keep)
        self._record_dropped(req.id, req.plan, req.submit_t, req.tenant,
                             "expired")
        del self._active[req.id]
        if req.form is not None:
            primary = self._inflight_forms.get(req.form.key)
            if primary is not None and primary[0] == req.id:
                self._inflight_forms.pop(req.form.key, None)
            for frid, g, sla, plan, form, t0, tenant in self._followers.pop(
                req.form.key, []
            ):
                budget = self._budget(sla, t0, self._clock())
                if not self._shed_if_floor_late(frid, g, sla, plan, budget,
                                                t0, tenant):
                    self._admit(frid, g, sla, plan, form, False, None,
                                tenant=tenant, t0=t0)

    # ------------------------------------------------------------- solve --
    def pump(self) -> bool:
        """One deterministic event-loop tick: drain the admission queue,
        re-score queued requests against their residual deadlines (§6.6:
        downgrade / expire before dispatch), fill the dispatch window (up
        to ``max_inflight`` batches issued without blocking), then
        harvest the oldest in-flight batch and run any merges it
        unblocks. Returns True while work remains."""
        self._process_admissions()
        self._rescore_queued()
        window = max(self.config.max_inflight, 1)  # 0 would never dispatch
        while len(self._inflight) < window:
            if not self._dispatch_one():
                break
        if self._inflight:
            self._harvest_one()
        return bool(
            self._inflight
            or self._admission
            or any(self._buckets.values())
        )

    def drain(self) -> "OrderedDict[int, RequestResult]":
        """Run the scheduler until every admitted request has a result."""
        while self.pump():
            pass
        return self.results

    # ----------------------------------------------------------- metrics --
    def metrics_registry(self) -> MetricsRegistry:
        """§8: the service's stats as a `MetricsRegistry` — counters and
        gauges copied at call time, latency histograms attached live —
        for JSON / Prometheus export (`serve_maxcut --metrics-out`)."""
        reg = MetricsRegistry()
        s = self.stats
        for f in _counter_fields(s):
            reg.counter(f"service.{f}").inc(getattr(s, f))
        reg.gauge("service.fill_ratio").set(s.fill_ratio)
        reg.gauge("service.attainment").set(s.attainment)
        reg.gauge("service.inflight").set(len(self._inflight))
        reg.attach_histogram("service.latency", s.latency)
        for t, ts in s.tenants.items():
            for f in ("submitted", "completed", "shed", "expired",
                      "sla_met", "sla_missed"):
                reg.counter(f"tenant.{t}.{f}").inc(getattr(ts, f))
            reg.attach_histogram(f"tenant.{t}.latency", ts.latency)
        return reg

    # ------------------------------------------------------------- merge --
    def _merge(self, req: _Request) -> None:
        anytime: list = []
        # §8: the merge span carries the observe_merge payload in its
        # attrs; installing the service tracer globally + attaching the
        # span parents `core.merge.merge_stream`'s per-level spans under
        # it without threading tracer arguments through the core API
        ms = self.trace.begin(
            "merge", parent=self._req_spans.get(req.id),
            knobs=req.plan.knobs, m=req.part.m, n_edges=req.graph.n_edges,
        )
        lin = req.prob.linear.numpy() if req.has_lin else None
        on_stream = (torch.cuda.stream(self._merge_stream)
                     if self._merge_stream is not None
                     else contextlib.nullcontext())
        with trace_mod.use_tracer(self.trace), self.trace.attach(ms), on_stream:
            if req.stream and req.part.m >= self.config.anytime_min_levels:
                plan, bw = para_mod.merge_inputs(
                    req.part, req.bit_indices, req.cfg, linear=lin,
                    device=self.device,
                )
                best_cut, best_assign = -np.inf, None
                for snap in merge_mod.merge_stream(plan, bw):
                    # the stream scores the internal objective; surface
                    # the full one (offset is exactly 0.0 for Max-Cut)
                    val = snap.cut_value + req.prob.offset
                    if val > best_cut:
                        best_cut, best_assign = val, snap.assignment
                    anytime.append((snap.level, snap.n_levels, best_cut))
                    if req.on_update is not None:
                        req.on_update(req.id, snap.level, snap.n_levels,
                                      best_cut)
                assignment = best_assign
            else:
                assignment, _, _ = para_mod.merge_candidates(
                    req.part, req.bit_indices, req.cfg, linear=lin,
                    device=self.device,
                )
            # final re-score from scratch, exactly as core.solve reconciles
            # — the *full* objective, so a QUBO/MIS result and its cached
            # replay can never disagree on the linear part
            cut = float(problem_value(req.prob, torch.as_tensor(assignment)))
        self.trace.end(ms)
        self._observe(ms)
        if req.stream and not anytime:
            # single-level merges skip the stream; still honor the anytime
            # contract with one final update
            anytime.append((1, 1, cut))
            if req.on_update is not None:
                req.on_update(req.id, 1, 1, cut)

        now = self._clock()
        if self.config.enable_cache:
            self.cache.store(
                req.prob,
                assignment,
                cut,
                quality=req.plan.quality,
                form=req.form,
            )
        met = None if req.deadline_t is None else bool(now <= req.deadline_t)
        self.results[req.id] = RequestResult(
            request_id=req.id,
            assignment=np.asarray(assignment),
            cut_value=cut,
            cached=False,
            plan=req.plan,
            latency_s=now - req.submit_t,
            timings={
                "solve_s": req.solve_done_t - req.submit_t,
                "merge_s": now - req.solve_done_t,
                "total_s": now - req.submit_t,
            },
            anytime=anytime,
            tenant=req.tenant,
            dispatches_waited=self.stats.dispatches - req.admit_dispatch,
            deadline_met=met,
            downgrades=req.downgrades,
        )
        self.stats.completed += 1
        ts = self.stats.tenant(req.tenant)
        ts.completed += 1
        self._count_deadline(met, ts)
        self.stats.latency.observe(now - req.submit_t)
        ts.latency.observe(now - req.submit_t)
        if req.downgrades:
            self.stats.downgraded += 1
            ts.downgraded += 1
        self._end_request_span(req.id, "completed", cached=False)
        del self._active[req.id]

        # serve coalesced isomorphic followers from the just-stored entry
        if req.form is not None:
            self._inflight_forms.pop(req.form.key, None)
            for frid, g, sla, plan, form, t0, tenant in self._followers.pop(
                req.form.key, []
            ):
                hit = self.cache.lookup(g, form=form, min_quality=plan.quality)
                if hit is not None:
                    self._record_cached(
                        frid, g, plan, hit[0], hit[1], t0, tenant=tenant,
                        deadline_t=None if sla.deadline_s is None
                        else t0 + sla.deadline_s,
                    )
                else:
                    # canonical-key collision (or a primary downgraded
                    # below this follower's required quality) surfaced by
                    # the cache's gate: solve the follower for real,
                    # re-scored against its own residual budget
                    budget = self._budget(sla, t0, self._clock())
                    if not self._shed_if_floor_late(frid, g, sla, plan,
                                                    budget, t0, tenant):
                        self._admit(frid, g, sla, plan, form, False, None,
                                    tenant=tenant, t0=t0)
