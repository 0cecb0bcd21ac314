"""SLA-driven knob selection (port of ``repro/service/planner.py``;
docs/DESIGN.md §6.2).

The paper's §4.2 parameter taxonomy exposes (K, L, opt_steps, N) as
per-invocation flags; the service chooses them *per request* from a
deadline / accuracy target. A small calibrated cost model — per-stage
coefficients fitted from stage timings — predicts (partition_s, solve_s,
merge_s) for every knob tuple in a candidate grid; the planner then picks,
among the tuples predicted to meet the deadline, the cheapest that reaches
the accuracy target, else the highest-quality one. Because the feasible
set only shrinks as the deadline tightens and selection maximizes quality
within it, a tighter deadline can never select a slower-predicted tuple.

Quality is a monotone proxy score over the knobs (the paper's Figs. 9-10
trends: cut quality rises with K, beam/L, N, and optimizer steps), shared
with the result cache's equal-or-better-quality gate.

The prior is the card's own (`load_prior`): ``calibration.json`` beside
this module, written by ``chip_smoke.py`` (phase 21a) from warm solves on
the GPU through the service's dispatch, in the reference's
``BENCH_distributed.json`` schema (``mode: "single"`` rows, each with the
knobs it ran at, over several T, p and N), with the card's name and power
limit and a ``fixed`` block of the per-dispatch and per-subgraph terms
fitted there. Without the file the defaults of `CostModel()` apply, as in
the reference. The scheduler streams served-request stage timings back
through `observe_partition` / `observe_solve` / `observe_merge`, each an
exponentially weighted blend of the implied per-work-unit coefficient into
the live `CostModel`. Selection
monotonicity is structural — it holds for any non-negative coefficient
values, so it survives every refit — and a planner that never observes
keeps its fitted model bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import NamedTuple, Sequence

import numpy as np


class KnobTuple(NamedTuple):
    """One candidate setting of the paper's §4.2 tunable knobs."""

    n_qubits: int  # N — per-solver qubit budget
    top_k: int  # K — candidates kept per subgraph
    opt_steps: int  # Adam steps on <cut>
    beam_width: int  # merge frontier width (the L knob's work volume)
    p_layers: int = 2


class StageCost(NamedTuple):
    partition_s: float
    solve_s: float
    merge_s: float

    @property
    def total_s(self) -> float:
        return self.partition_s + self.solve_s + self.merge_s


class KnobPlan(NamedTuple):
    """Planner output: the chosen knobs plus their predictions."""

    knobs: KnobTuple
    merge_level: int  # L, clamped to the predicted partition depth
    predicted: StageCost
    quality: float
    meets_deadline: bool
    meets_quality: bool

    def to_config(self):
        """`ParaQAOAConfig` for this plan — the single knob→config
        mapping shared by the scheduler, the benches, and every
        service-vs-solo parity check (so a new knob field cannot be
        silently dropped from one of them)."""
        from repro_torch.core import paraqaoa  # service→core only, no cycle

        kn = self.knobs
        return paraqaoa.ParaQAOAConfig(
            n_qubits=kn.n_qubits,
            top_k=kn.top_k,
            merge_level=self.merge_level,
            p_layers=kn.p_layers,
            opt_steps=kn.opt_steps,
            beam_width=kn.beam_width,
        )


@dataclasses.dataclass(frozen=True)
class SLA:
    """Per-request service-level objective. `None` means unconstrained.

    ``floor_quality`` is the *hard* accuracy floor of the deadline
    enforcement path (docs/DESIGN.md §6.6): a downgrade re-plan may walk the
    knob lattice down only to tuples whose `quality_score` still meets
    it, and a request whose floor plan is predicted to miss the residual
    deadline is shed rather than served below the floor.
    ``target_quality`` remains the *soft* target `plan` optimizes for.
    """

    deadline_s: float | None = None
    target_quality: float | None = None
    floor_quality: float | None = None


class ReplanDecision(NamedTuple):
    """Outcome of a deadline re-score (docs/DESIGN.md §6.6).

    ``verdict`` is one of:
      - ``"keep"``      — the current plan is still predicted to meet the
                          residual budget; ``plan`` is the current plan;
      - ``"downgrade"`` — the current plan is predicted late but a
                          floor-meeting tuple fits; ``plan`` is the new
                          (cheaper) plan;
      - ``"shed"``      — even the floor plan is predicted late (or the
                          declared floor is unreachable in the grid);
                          ``plan`` is None.
    """

    verdict: str
    plan: "KnobPlan | None"
    floor_predicted_s: float  # the floor plan's predicted total (inf if
    #                           the floor is unreachable in the grid)


def quality_score(knobs: KnobTuple) -> float:
    """Monotone accuracy proxy over the knob tuple; higher is better.

    Calibrated ordering, not an AR prediction: each term follows the
    paper's measured trend direction (K: Fig. 9, beam/L: Fig. 10,
    N: §4.2, opt_steps: the ansatz optimizer), with diminishing returns
    via log/ratio shaping.
    """
    return (
        float(knobs.n_qubits)
        + 2.0 * math.log2(knobs.top_k)
        + 0.5 * math.log2(knobs.beam_width)
        + 3.0 * knobs.opt_steps / (knobs.opt_steps + 10.0)
    )


def _subgraph_count(n_vertices: int, n_qubits: int) -> int:
    if n_vertices <= n_qubits:
        return 1
    return math.ceil(n_vertices / (n_qubits - 1))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-stage linear coefficients over closed-form work terms.

    partition ~ c_partition · (|E| + |V|)           (host preprocessing)
    solve     ~ c_solve · M·(T+1)·p·2^N + c_dispatch·ceil(M/B)
    merge     ~ c_merge · W·K·|E| + c_merge_base·M  (frontier × extensions
                                                     × edges scored once)
    """

    c_partition: float = 2.5e-8
    c_solve: float = 6.0e-8
    c_dispatch: float = 2.0e-2
    c_merge: float = 1.2e-8
    c_merge_base: float = 1.0e-3
    batch_slots: int = 16

    def predict(
        self, n_vertices: int, n_edges: int, knobs: KnobTuple
    ) -> StageCost:
        m = _subgraph_count(n_vertices, knobs.n_qubits)
        e = max(n_edges, 1)
        part = self.c_partition * (e + n_vertices)
        amp_steps = m * (knobs.opt_steps + 1) * knobs.p_layers * 2**knobs.n_qubits
        solve = self.c_solve * amp_steps + self.c_dispatch * math.ceil(
            m / self.batch_slots
        )
        merge = self.c_merge * knobs.beam_width * knobs.top_k * e + (
            self.c_merge_base * m
        )
        return StageCost(part, solve, merge)

    @classmethod
    def fit(
        cls,
        rows: Sequence[dict],
        knobs: KnobTuple,
        edge_prob: float = 0.02,
        **overrides,
    ) -> "CostModel":
        """Fit coefficients from benchmark stage-timing rows.

        Rows follow the single-device schema of ``BENCH_distributed.json``:
        each carries `n`, `partition_s`, `solve_s`, `merge_s` (and `m` when
        recorded); `knobs` are the settings the suite ran with and
        `edge_prob` recovers |E| for rows that predate an explicit edge
        count. Coefficients are the median observed time-per-work-unit, so
        one outlier row cannot skew the model. A row may carry its own
        ``knobs`` (a `KnobTuple`'s fields), which take the place of
        ``knobs`` for that row; the reference's rows carry none.
        """
        base = cls(**overrides)
        c_part, c_solve, c_merge = [], [], []
        for row in rows:
            if "partition_s" not in row or "n" not in row:
                continue
            kn = KnobTuple(**row["knobs"]) if row.get("knobs") else knobs
            n = int(row["n"])
            e = int(row.get("edges") or edge_prob * n * (n - 1) / 2)
            m = int(row.get("m") or _subgraph_count(n, kn.n_qubits))
            c_part.append(row["partition_s"] / max(e + n, 1))
            amp = m * (kn.opt_steps + 1) * kn.p_layers * 2**kn.n_qubits
            c_solve.append(
                max(row["solve_s"] - base.c_dispatch * math.ceil(m / base.batch_slots), 0.0)
                / max(amp, 1)
            )
            c_merge.append(
                max(row["merge_s"] - base.c_merge_base * m, 0.0)
                / max(kn.beam_width * kn.top_k * e, 1)
            )
        if not c_part:
            return base
        return dataclasses.replace(
            base,
            c_partition=float(np.median(c_part)),
            c_solve=float(np.median(c_solve)),
            c_merge=float(np.median(c_merge)),
        )

    @classmethod
    def from_bench_file(
        cls, path: str, knobs: KnobTuple | None = None, **kwargs
    ) -> "CostModel":
        """Calibrate from a stage-timing file's ``mode: "single"`` rows;
        defaults on any miss. The knob settings below are those the rows
        were run with (``benchmarks/large_scale.py --distributed``'s, and
        ``chip_smoke.py`` phase 21a's)."""
        knobs = knobs or KnobTuple(
            n_qubits=10, top_k=1, opt_steps=12, beam_width=64, p_layers=2
        )
        try:
            with open(path) as f:
                payload = json.load(f)
            rows = [
                r for r in payload.get("rows", []) if r.get("mode") == "single"
            ]
            return cls.fit(rows, knobs, **kwargs)
        except (OSError, ValueError, KeyError):
            return cls(**kwargs)


# the card's own stage timings (chip_smoke.py phase 21a), shipped with
# the package; missing → `CostModel()`'s defaults
DEFAULT_BENCH_PATH = os.path.join(os.path.dirname(__file__), "calibration.json")


def load_prior(path: str = DEFAULT_BENCH_PATH) -> CostModel:
    """`Planner()`'s prior: `CostModel.from_bench_file` on ``path``, with
    the file's ``fixed`` block (``c_dispatch`` and ``c_merge_base`` fitted
    on the card by ``chip_smoke.py`` phase 21a, and the ``batch_slots`` its
    rows were dispatched with) as its overrides in place of the
    reference's defaults. A file without the block fits as the reference
    does."""
    try:
        with open(path) as f:
            fixed = json.load(f).get("fixed") or {}
    except (OSError, ValueError):
        fixed = {}
    return CostModel.from_bench_file(path, **fixed)


# the candidate grid: small enough to scan per request, wide enough to
# span ~3 orders of magnitude in predicted cost
DEFAULT_GRID: tuple = tuple(
    KnobTuple(n_qubits=nq, top_k=k, opt_steps=t, beam_width=w)
    for nq in (6, 8, 10, 12)
    for k in (1, 2, 4)
    for t in (4, 12, 30)
    for w in (32, 128, 512)
)


@dataclasses.dataclass
class CalibrationStats:
    """Streaming-refit bookkeeping: how many served-request observations
    have been blended into each stage coefficient."""

    partition_obs: int = 0
    solve_obs: int = 0
    merge_obs: int = 0

    @property
    def total(self) -> int:
        return self.partition_obs + self.solve_obs + self.merge_obs

    def as_dict(self) -> dict:
        return {
            "partition_obs": self.partition_obs,
            "solve_obs": self.solve_obs,
            "merge_obs": self.merge_obs,
        }


class Planner:
    """Maps (graph size, SLA) → the knob tuple the scheduler should run.

    ``recalibrate_alpha`` is the exponential weight of the streaming
    refit: each `observe_*` call blends the observed per-work-unit
    coefficient as ``c ← (1-α)·c + α·obs``. With zero observations the
    cost model stays bit-for-bit the fitted prior.
    """

    def __init__(
        self,
        cost_model: CostModel | None = None,
        grid: Sequence[KnobTuple] = DEFAULT_GRID,
        max_qubits: int | None = None,
        default_merge_level: int = 2,
        batch_slots: int | None = None,
        recalibrate_alpha: float = 0.25,
    ):
        self.cost_model = cost_model or load_prior()
        if batch_slots is not None:
            # predict dispatch counts for the batch size the scheduler
            # actually runs, not the model's default
            self.cost_model = dataclasses.replace(
                self.cost_model, batch_slots=batch_slots
            )
        if max_qubits is not None:
            grid = [kn for kn in grid if kn.n_qubits <= max_qubits]
        if not grid:
            raise ValueError("empty knob grid")
        self.grid = list(grid)
        self.default_merge_level = default_merge_level
        if not 0.0 < recalibrate_alpha <= 1.0:
            raise ValueError(f"recalibrate_alpha out of (0, 1]: {recalibrate_alpha}")
        self.recalibrate_alpha = recalibrate_alpha
        self.base_model = self.cost_model  # the pre-refit fitted prior
        self.calibration = CalibrationStats()

    # ------------------------------------------------- streaming refit --
    def _blend(self, field: str, observed: float) -> None:
        """One EW refit step of a single coefficient; clamps at >= 0 so
        selection monotonicity (structural over non-negative coefficients)
        survives arbitrary observation streams."""
        obs = max(float(observed), 0.0)
        a = self.recalibrate_alpha
        cur = getattr(self.cost_model, field)
        self.cost_model = dataclasses.replace(
            self.cost_model, **{field: (1.0 - a) * cur + a * obs}
        )

    def observe_partition(
        self, n_vertices: int, n_edges: int, seconds: float
    ) -> None:
        """Blend one measured host-partition time into `c_partition`."""
        self.calibration.partition_obs += 1
        self._blend("c_partition", seconds / max(n_edges + n_vertices, 1))

    def observe_solve(
        self,
        n_qubits: int,
        p_layers: int,
        opt_steps: int,
        slots: int,
        seconds: float,
    ) -> None:
        """Blend one measured batch-dispatch time into `c_solve`.

        ``slots`` is the dispatched row count (padding rows run the full
        computation, so they count as work); the model's per-dispatch
        overhead term is subtracted before normalizing.
        """
        work = slots * (opt_steps + 1) * p_layers * 2**n_qubits
        self.calibration.solve_obs += 1
        self._blend(
            "c_solve",
            max(seconds - self.cost_model.c_dispatch, 0.0) / max(work, 1),
        )

    def observe_merge(
        self, knobs: KnobTuple, m: int, n_edges: int, seconds: float
    ) -> None:
        """Blend one measured per-request merge time into `c_merge`."""
        work = knobs.beam_width * knobs.top_k * max(n_edges, 1)
        self.calibration.merge_obs += 1
        self._blend(
            "c_merge",
            max(seconds - self.cost_model.c_merge_base * m, 0.0)
            / max(work, 1),
        )

    def observe_span(self, span) -> None:
        """Recalibration from the span stream. The scheduler hands
        every closed stage span here; spans carry their observation
        payload in their attrs, and this dispatches on the span name to
        the per-stage observers above. Unknown span names are ignored,
        so the scheduler can stream its whole trace without filtering.
        """
        a = span.attrs
        if span.name == "partition":
            self.observe_partition(a["n"], a["n_edges"], span.duration_s)
        elif span.name == "solve":
            self.observe_solve(a["n_qubits"], a["p_layers"], a["opt_steps"],
                               a["slots"], span.duration_s)
        elif span.name == "merge":
            self.observe_merge(a["knobs"], a["m"], a["n_edges"],
                               span.duration_s)

    def _lattice(self, floor_quality: float | None) -> list[KnobTuple]:
        """The knob lattice a request may occupy: grid tuples meeting the
        declared hard accuracy floor. An unreachable floor returns [] —
        the caller decides between shed (deadline enforcement) and
        best-effort (no deadline)."""
        if floor_quality is None:
            return self.grid
        return [
            kn for kn in self.grid
            if quality_score(kn) >= floor_quality - 1e-12
        ]

    def floor_predicted(
        self, n_vertices: int, n_edges: int, floor_quality: float | None
    ) -> tuple[KnobTuple, StageCost] | None:
        """The *floor plan*: the cheapest-predicted tuple still meeting
        the declared accuracy floor — the last stop on the downgrade
        lattice before shedding. None when the floor is unreachable in
        the grid (no tuple scores high enough)."""
        lattice = self._lattice(floor_quality)
        if not lattice:
            return None
        return min(
            ((kn, self.cost_model.predict(n_vertices, n_edges, kn))
             for kn in lattice),
            key=lambda s: (s[1].total_s, s[0]),
        )

    def replan(
        self,
        n_vertices: int,
        n_edges: int,
        budget_s: float,
        current: KnobPlan,
        floor_quality: float | None = None,
    ) -> ReplanDecision:
        """Re-score one queued request against its residual wall-clock
        budget (docs/DESIGN.md §6.6).

        Keep the current plan while it is still predicted to fit the
        budget. Otherwise walk the knob lattice to the cheapest-predicted
        floor-meeting tuple that fits — the cost model has already been
        wrong once for this request (its original prediction no longer
        holds), so a downgrade maximizes safety margin instead of
        squeezing quality; ties break toward higher quality, then the
        tuple. When even the floor plan is predicted late, the verdict is
        shed. Monotone in the budget by construction: the kept plan's
        predicted time is fixed, the downgrade target is the lattice-wide
        minimum, and a shrinking budget can only move keep → downgrade →
        shed, never backward in predicted time.
        """
        floor = self.floor_predicted(n_vertices, n_edges, floor_quality)
        if floor is None:  # declared floor unreachable in the grid
            return ReplanDecision("shed", None, float("inf"))
        floor_s = floor[1].total_s
        cur_pred = self.cost_model.predict(n_vertices, n_edges, current.knobs)
        if cur_pred.total_s <= budget_s:
            return ReplanDecision("keep", current, floor_s)
        if floor_s > budget_s:
            return ReplanDecision("shed", None, floor_s)
        scored = [
            (kn, self.cost_model.predict(n_vertices, n_edges, kn),
             quality_score(kn))
            for kn in self._lattice(floor_quality)
        ]
        feasible = [s for s in scored if s[1].total_s <= budget_s]
        choice = min(feasible, key=lambda s: (s[1].total_s, -s[2], s[0]))
        plan = self._finish(
            choice, n_vertices, True,
            choice[2] >= (floor_quality or -math.inf), SLA(),
        )
        return ReplanDecision("downgrade", plan, floor_s)

    def plan(self, n_vertices: int, n_edges: int, sla: SLA = SLA()) -> KnobPlan:
        """Pick knobs for one request.

        Selection: among tuples predicted to meet the deadline, the
        cheapest that reaches the accuracy target; if none reaches it,
        the highest-quality feasible tuple; if nothing fits the deadline
        at all, the fastest tuple (best effort). Ties break toward lower
        predicted time, then the knob tuple itself, so planning is
        deterministic — and tightening the deadline can only move the
        choice to an equal-or-faster-predicted tuple. A declared
        ``sla.floor_quality`` restricts the candidate lattice to
        floor-meeting tuples (an unreachable floor falls back to the full
        grid — the shed decision belongs to the scheduler's enforcement
        path, not to planning).
        """
        lattice = self._lattice(sla.floor_quality) or self.grid
        scored = []
        for kn in lattice:
            pred = self.cost_model.predict(n_vertices, n_edges, kn)
            scored.append((kn, pred, quality_score(kn)))

        deadline = sla.deadline_s
        feasible = [
            s for s in scored if deadline is None or s[1].total_s <= deadline
        ]
        meets_deadline = bool(feasible)
        if not feasible:  # best effort: fastest tuple in the grid
            choice = min(scored, key=lambda s: (s[1].total_s, s[0]))
            return self._finish(choice, n_vertices, False, False, sla)

        target = sla.target_quality
        if target is not None:
            reaching = [s for s in feasible if s[2] >= target]
            if reaching:
                # meet the accuracy target at minimum predicted cost
                choice = min(reaching, key=lambda s: (s[1].total_s, s[0]))
                return self._finish(choice, n_vertices, True, True, sla)
        # no (reachable) target: maximize quality within the deadline
        choice = max(
            feasible, key=lambda s: (s[2], -s[1].total_s, s[0])
        )
        return self._finish(choice, n_vertices, True, target is None, sla)

    def _finish(self, choice, n_vertices, meets_deadline, meets_quality, sla):
        kn, pred, qual = choice
        m = _subgraph_count(n_vertices, kn.n_qubits)
        return KnobPlan(
            knobs=kn,
            merge_level=min(self.default_merge_level, max(m - 1, 0)),
            predicted=pred,
            quality=qual,
            meets_deadline=meets_deadline,
            meets_quality=meets_quality if sla.target_quality is not None else True,
        )
