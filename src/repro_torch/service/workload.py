"""Seed-stable request-mix generation for the service drivers (port of
``repro/service/workload.py``; the same seed gives the reference's graphs
and arrivals): varied-size
Erdős-Rényi instances with a controllable fraction of vertex-relabeled
repeats, the traffic shape that exercises the canonical-graph cache.

Production-shaped traffic for the deadline soak lives here too: an
*open-loop* arrival process (`arrival_trace` — Poisson base rate, burst
episodes, the skewed `tenant_mix` assignment, and a per-request
deadline / accuracy-floor mix) plus the two drivers that replay it
against a `SolveService`. `run_soak_virtual` advances an injectable
`VirtualClock` a fixed virtual cost per pump tick, so a soak of
thousands of requests is bit-deterministic and replayable; `run_soak_wall`
replays the same trace in wall-clock time. Both are
open-loop: arrivals are submitted when the trace says so, never gated on
the service keeping up — and a request's deadline is anchored at its
*arrival* time, so budget burned waiting to be noticed is burned."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.graph import Graph, Problem
from repro_torch.service.planner import SLA


def relabel(graph: Graph, perm: np.ndarray) -> Graph:
    """The same instance under a vertex permutation (isomorphic copy)."""
    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights)[: graph.n_edges]
    return Graph.from_edges(graph.n, perm[e], w)


def relabel_problem(prob: Problem, perm: np.ndarray) -> Problem:
    """The same `Problem` under a vertex permutation: the quadratic edges
    and the per-vertex linear terms move together (vertex v → perm[v])."""
    lin = np.zeros(prob.n, dtype=np.float32)
    lin[perm] = np.asarray(prob.linear, dtype=np.float32)
    return dataclasses.replace(
        prob, graph=relabel(prob.graph, perm), linear=torch.from_numpy(lin)
    )


def _generate(n: int, p: float, seed: int, weights: str) -> Graph:
    """One seed-stable instance; ``weights``: "unit" | "uniform" | "spin"."""
    if weights == "uniform":
        return Graph.erdos_renyi_weighted(n, p, seed=seed)
    if weights == "spin":
        return Graph.spin_glass(n, p, seed=seed)
    if weights != "unit":
        raise ValueError(f"unknown weight family: {weights!r}")
    return Graph.erdos_renyi(n, p, seed=seed)


def request_mix(
    load: int,
    n_range: tuple,
    p: float,
    repeat_frac: float,
    seed: int,
    weights: str = "unit",
) -> list:
    """Seed-stable graphs for one offered load; ~repeat_frac of them are
    vertex-relabeled copies of earlier ones (isomorphic, cache-hittable).
    ``weights`` selects the instance family: unit-weight ER (default),
    uniform-weight ER, or ±1 spin glass."""
    rng = np.random.default_rng(seed)
    fresh, graphs = [], []
    for _ in range(load):
        if fresh and rng.random() < repeat_frac:
            g0 = fresh[int(rng.integers(len(fresh)))]
            perm = rng.permutation(g0.n).astype(np.int32)
            graphs.append(relabel(g0, perm))
        else:
            n = int(rng.integers(n_range[0], n_range[1] + 1))
            g = _generate(n, p, int(rng.integers(1 << 30)), weights)
            fresh.append(g)
            graphs.append(g)
    return graphs


def problem_mix(
    load: int,
    n_range: tuple,
    p: float,
    repeat_frac: float,
    seed: int,
    problem: str = "maxcut",
    weights: str = "unit",
) -> list:
    """Seed-stable `Problem` requests for one offered load.

    ``problem``: "maxcut" returns plain graphs (exactly `request_mix`);
    "mis" wraps each topology in the penalty-QUBO MIS encoding; "qubo"
    draws a random QUBO (graph quadratic + N(0,1) linear terms). Repeats
    are vertex-relabeled copies — for problems, the linear terms permute
    with the vertices, so the canonical cache should still hit."""
    if problem == "maxcut":
        return request_mix(load, n_range, p, repeat_frac, seed, weights)
    rng = np.random.default_rng(seed)
    fresh, probs = [], []
    for _ in range(load):
        if fresh and rng.random() < repeat_frac:
            p0 = fresh[int(rng.integers(len(fresh)))]
            perm = rng.permutation(p0.n).astype(np.int32)
            probs.append(relabel_problem(p0, perm))
        else:
            n = int(rng.integers(n_range[0], n_range[1] + 1))
            g = _generate(n, p, int(rng.integers(1 << 30)), weights)
            if problem == "mis":
                pr = Problem.mis(g)
            elif problem == "qubo":
                e = np.asarray(g.edges)[: g.n_edges]
                q = np.asarray(g.weights)[: g.n_edges]
                lin = rng.normal(size=n).astype(np.float32)
                pr = Problem.qubo(n, e, q, linear=lin)
            else:
                raise ValueError(f"unknown problem family: {problem!r}")
            fresh.append(pr)
            probs.append(pr)
    return probs


def tenant_mix(load: int, tenants: int, seed: int) -> list:
    """Seed-stable tenant labels (``"t0"``…) for one offered load.

    A *skewed* assignment — tenant ``t0`` claims roughly half the
    requests, the rest split evenly — because uniform traffic never
    exercises the scheduler's fairness/quota path.
    With one tenant everything is ``"t0"``.
    """
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1: {tenants}")
    rng = np.random.default_rng(seed + 0x7E7A)
    labels = []
    for _ in range(load):
        if tenants == 1 or rng.random() < 0.5:
            labels.append("t0")
        else:
            labels.append(f"t{int(rng.integers(1, tenants))}")
    return labels


# -------------------------------------------------------- open-loop soak --
class VirtualClock:
    """A deterministic, manually advanced time source.

    Injected as ``SolveService(clock=...)`` it replaces every wall-clock
    read in the scheduler — deadline math, latency stamps, recalibration
    observations — so a whole soak replays bit-for-bit. Callable (the
    scheduler's clock contract) and monotone (``advance`` refuses to go
    backward).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backward: {dt}")
        self._now += dt

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, float(t))


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: when, what, whose, and under which SLA."""

    t: float  # arrival time (virtual or wall seconds from soak start)
    graph: Graph
    tenant: str
    deadline_s: float | None  # relative to arrival, not submission
    floor_quality: float | None = None


def arrival_trace(
    load: int,
    rate_rps: float,
    n_range: tuple,
    p: float,
    seed: int,
    *,
    repeat_frac: float = 0.25,
    tenants: int = 2,
    burst_factor: float = 4.0,
    burst_every_s: float = 20.0,
    burst_len_s: float = 4.0,
    deadline_choices: tuple = (2.0, 8.0),
    floor_choices: tuple = (None,),
) -> list:
    """Seed-stable open-loop arrival process for one offered load.

    Inter-arrival gaps are unit-rate exponential draws scaled by the
    instantaneous rate: the Poisson base ``rate_rps``, multiplied by
    ``burst_factor`` during burst episodes (the first ``burst_len_s`` of
    every ``burst_every_s`` window — deterministic episodes, so two
    traces at different rates stay comparable). The graph mix and the
    skewed tenant assignment reuse `request_mix` / `tenant_mix` with the
    same seed, so **changing ``rate_rps`` rescales arrival times without
    changing which requests arrive** — that is what makes
    attainment-vs-offered-load curves (and their monotonicity test)
    apples-to-apples. Deadlines and accuracy floors are drawn per
    request from the given choice tuples (``None`` = unconstrained).
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0: {rate_rps}")
    graphs = request_mix(load, n_range, p, repeat_frac, seed)
    labels = tenant_mix(load, tenants, seed)
    rng = np.random.default_rng(seed + 0x51A)
    trace, t = [], 0.0
    for g, tenant in zip(graphs, labels):
        in_burst = burst_factor > 1.0 and (t % burst_every_s) < burst_len_s
        rate = rate_rps * (burst_factor if in_burst else 1.0)
        t += float(rng.exponential(1.0)) / rate
        deadline = deadline_choices[int(rng.integers(len(deadline_choices)))]
        floor = floor_choices[int(rng.integers(len(floor_choices)))]
        trace.append(Arrival(t, g, tenant, deadline, floor))
    return trace


def _submit_arrival(svc, a: Arrival, now: float) -> int:
    """Open-loop submission: the deadline budget is residual from the
    *arrival* stamp — time spent unnoticed in the arrival queue counts."""
    deadline = None
    if a.deadline_s is not None:
        deadline = a.t + a.deadline_s - now
    return svc.submit(
        a.graph,
        SLA(deadline_s=deadline, floor_quality=a.floor_quality),
        tenant=a.tenant,
        defer=True,
    )


def run_soak_virtual(svc, clock: VirtualClock, trace, tick_s: float = 0.01):
    """Replay an arrival trace under a virtual clock; returns the rids
    aligned with the trace.

    Each `pump` tick costs exactly ``tick_s`` virtual seconds — the
    calibration knob relating offered load to service capacity — and
    idle gaps fast-forward to the next arrival. Everything downstream
    (deadline verdicts, latencies, stats) is a pure function of
    (trace, service config, tick_s), which is what the bit-determinism
    property of the service's tests asserts.
    """
    rids = []
    i = 0
    while True:
        now = clock.now()
        while i < len(trace) and trace[i].t <= now:
            rids.append(_submit_arrival(svc, trace[i], now))
            i += 1
        busy = svc.pump()
        if busy:
            clock.advance(tick_s)
        elif i < len(trace):
            clock.advance_to(max(trace[i].t, now + tick_s))
        else:
            break
    return rids


def run_soak_wall(svc, trace, *, max_idle_sleep_s: float = 0.002):
    """Replay an arrival trace in wall-clock time (the bench mode);
    returns (rids, wall_seconds). Open-loop: if the service falls
    behind, due arrivals flood in unthrottled."""
    rids = []
    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i].t <= now:
            rids.append(_submit_arrival(svc, trace[i], now))
            i += 1
        busy = svc.pump()
        if not busy:
            if i >= len(trace):
                break
            gap = trace[i].t - (time.perf_counter() - t0)
            if gap > 0:
                time.sleep(min(gap, max_idle_sleep_s))
    return rids, time.perf_counter() - t0


def latency_summary(svc) -> dict:
    """Completed-request latency summary for a drained soak, straight
    from the service's shared obs histogram (count/sum/p50/p99) — the
    single percentile implementation every caller reads."""
    return svc.stats.latency.summary()
