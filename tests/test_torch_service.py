"""The port's solve service against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
What each comparison holds, and why:

- canonical keys and permutations, the result cache, the planner and the
  workload generators are numpy and Python in both packages: equal byte
  for byte and float for float;
- `merge_stream` fed the same plan (unit weights, so every score is an
  exact f32 integer): equal snapshots;
- the scheduler under a `VirtualClock`, recalibration off and the same
  grid on both sides: the same packing (the request ids of every
  `dispatch` span), plans, terminal states and tenant stats. At
  ``opt_steps = 0`` every dispatched row's candidates are equal up to
  exact ties of the marginals, decided in float64 (`marginal64`, as the
  baselines' tests do);
- the port's service against the port's solo `solve()`: bit for bit
  (Max-Cut, QUBO, MIS), and the mesh backend against the local one;
- `solve_subgraph_batch` reads nothing back from its tensors.
"""

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import merge as jmerge
from repro.core import partition as jpart
from repro.service import cache as jcache
from repro.service import canonical as jcanon
from repro.service import planner as jplanner
from repro.service import scheduler as jsched
from repro.service import workload as jwork
from repro.obs.trace import Tracer as JTracer
from repro_torch.core import graph as tgraph
from repro_torch.core import merge as tmerge
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import partition as tpart
from repro_torch.core import qaoa as tqaoa
from repro_torch.obs.trace import Tracer as TTracer
from repro_torch.service import backend as tbackend
from repro_torch.service import cache as tcache
from repro_torch.service import canonical as tcanon
from repro_torch.service import planner as tplanner
from repro_torch.service import scheduler as tsched
from repro_torch.service import workload as twork
from test_torch_baselines import marginal64, tie64

REPO = Path(__file__).resolve().parent.parent
BENCH = str(REPO / "results" / "BENCH_distributed.json")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graph(pkg, kind, n, p, seed):
    G = pkg.Graph
    return {"unit": G.erdos_renyi, "uniform": G.erdos_renyi_weighted,
            "spin": G.spin_glass}[kind](n, p, seed=seed)


def _qubo(pkg, n, seed):
    rng = np.random.default_rng(seed)
    e = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                  if rng.random() < 0.2], dtype=np.int32)
    q = rng.normal(size=e.shape[0]).astype(np.float32)
    h = rng.normal(size=n).astype(np.float32)
    return pkg.Problem.qubo(n, e, q, linear=h, offset=0.5)


def _instance(case):
    """(JAX instance, port instance) of one canonical-key case."""
    kind, n, p = case
    if kind == "qubo":
        return _qubo(jgraph, n, 11), _qubo(tgraph, n, 11)
    if kind == "mis":
        return (jgraph.Problem.mis(jgraph.Graph.erdos_renyi(n, p, seed=12)),
                tgraph.Problem.mis(tgraph.Graph.erdos_renyi(n, p, seed=12)))
    if kind.startswith("relabel-"):
        base = kind.split("-", 1)[1]
        perm = np.random.default_rng(13).permutation(n).astype(np.int32)
        return (jwork.relabel(_graph(jgraph, base, n, p, 14), perm),
                twork.relabel(_graph(tgraph, base, n, p, 14), perm))
    return _graph(jgraph, kind, n, p, 15), _graph(tgraph, kind, n, p, 15)


# n below and above the exact-refinement threshold (256)
KEY_CASES = [("unit", 40, 0.2), ("uniform", 40, 0.2), ("spin", 40, 0.2),
             ("unit", 300, 0.02), ("uniform", 300, 0.02), ("spin", 300, 0.02),
             ("relabel-unit", 40, 0.2), ("relabel-uniform", 300, 0.02),
             ("qubo", 30, 0.0), ("mis", 40, 0.15)]


@pytest.mark.parametrize("case", KEY_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_canonical_form_equals_reference(case):
    j, t = _instance(case)
    jf, tf = jcanon.canonical_form(j), tcanon.canonical_form(t)
    assert tf.key == jf.key
    np.testing.assert_array_equal(tf.perm, jf.perm)
    assert (tf.n, tf.n_edges) == (jf.n, jf.n_edges)
    assert tcanon.canonical_key(t) == jcanon.canonical_key(j)


def test_relabelled_copies_share_the_key():
    g = _graph(tgraph, "unit", 40, 0.2, 16)
    perm = np.random.default_rng(17).permutation(40).astype(np.int32)
    assert tcanon.canonical_key(twork.relabel(g, perm)) == tcanon.canonical_key(g)


def test_result_cache_sequence_equals_reference():
    """Stores, hits, quality misses, a verify failure and evictions, op by
    op: the same returns and the same stats on both sides."""
    rng = np.random.default_rng(20)
    pairs = [_instance(("unit", 24, 0.3 + 0.05 * i)) for i in range(3)]
    perm = rng.permutation(24).astype(np.int32)
    twin = (jwork.relabel(pairs[0][0], perm), twork.relabel(pairs[0][1], perm))
    caches = (jcache.ResultCache(2), tcache.ResultCache(2))

    def assignment(g):
        return rng.integers(0, 2, g.n).astype(np.int8)

    ops = []
    for i, (jg, _) in enumerate(pairs):
        a = assignment(jg)
        ops.append(("store", i, a, float(jgraph.cut_value(jg, a)), 5.0 + i))
    ops += [("lookup", 0, 0.0), ("lookup", 2, 0.0), ("lookup", 2, 99.0),
            ("lookup", 1, 0.0), ("lookup", "twin", 0.0)]
    a = assignment(pairs[0][0])
    ops += [("store", 0, a, float(jgraph.cut_value(pairs[0][0], a)) + 7.0, 9.0),
            ("lookup", 0, 0.0), ("lookup", "twin", 0.0)]
    for op in ops:
        outs = []
        for side, c in enumerate(caches):
            inst = twin[side] if op[1] == "twin" else pairs[op[1]][side]
            if op[0] == "store":
                outs.append(c.store(inst, op[2], op[3], quality=op[4]))
            else:
                hit = c.lookup(inst, min_quality=op[2])
                outs.append(None if hit is None else (hit[0].tolist(), hit[1]))
            outs[-1] = (outs[-1], c.stats.as_dict(), c.keys())
        assert outs[0] == outs[1], op


def _plans_equal(a, b):
    assert tuple(a) == tuple(b)


def test_planner_equals_reference():
    jm = jplanner.CostModel.from_bench_file(BENCH)
    tm = tplanner.CostModel.from_bench_file(BENCH)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jp = jplanner.Planner(cost_model=jm, max_qubits=10, batch_slots=8)
    tp = tplanner.Planner(cost_model=tm, max_qubits=10, batch_slots=8)
    slas = [(None, None, None), (0.05, None, None), (0.5, 14.0, None),
            (2.0, None, 15.0), (30.0, 25.0, 12.0), (1e-4, None, None)]
    sizes = [(20, 40), (120, 700), (400, 8000), (2000, 40000)]
    for (n, e), (d, tq, fq) in [(s, x) for s in sizes for x in slas]:
        jsla = jplanner.SLA(deadline_s=d, target_quality=tq, floor_quality=fq)
        tsla = tplanner.SLA(deadline_s=d, target_quality=tq, floor_quality=fq)
        jplan, tplan = jp.plan(n, e, jsla), tp.plan(n, e, tsla)
        _plans_equal(tplan, jplan)
        assert tp.floor_predicted(n, e, fq) == jp.floor_predicted(n, e, fq)
        for budget in (1e-3, 0.1, 1.0, 100.0):
            jd = jp.replan(n, e, budget, jplan, floor_quality=fq)
            td = tp.replan(n, e, budget, tplan, floor_quality=fq)
            assert (td.verdict, td.floor_predicted_s) == (jd.verdict, jd.floor_predicted_s)
            assert (td.plan is None) == (jd.plan is None)
            if td.plan is not None:
                _plans_equal(td.plan, jd.plan)
    # streamed refits: the same coefficients after the same observations
    jk = jplanner.KnobTuple(8, 2, 12, 64)
    tk = tplanner.KnobTuple(8, 2, 12, 64)
    for i in range(5):
        for pl, kn in ((jp, jk), (tp, tk)):
            pl.observe_partition(100 + i, 500 + 7 * i, 0.01 * (i + 1))
            pl.observe_solve(8, 2, 12, 8, 0.05 + 0.01 * i)
            pl.observe_merge(kn, 12, 500, 0.002 * (i + 1))
    assert dataclasses.asdict(tp.cost_model) == dataclasses.asdict(jp.cost_model)
    assert tp.calibration.as_dict() == jp.calibration.as_dict()
    assert tplanner.DEFAULT_GRID == jplanner.DEFAULT_GRID


def test_default_prior_is_the_cards_calibration_not_the_cpu_bench():
    assert Path(tplanner.DEFAULT_BENCH_PATH).parent == Path(tplanner.__file__).parent
    with open(tplanner.DEFAULT_BENCH_PATH) as f:
        fixed = json.load(f)["fixed"]
    want = tplanner.CostModel.from_bench_file(tplanner.DEFAULT_BENCH_PATH, **fixed)
    assert tplanner.Planner().base_model == want == tplanner.load_prior()


def test_a_row_without_knobs_fits_as_the_reference():
    """Rows that carry no ``knobs`` fit exactly as the reference's `fit`;
    a row carrying the default knobs fits as one without them, and its
    own knobs are what its work terms count."""
    with open(BENCH) as f:
        rows = [r for r in json.load(f)["rows"] if r.get("mode") == "single"]
    knobs = tplanner.KnobTuple(n_qubits=10, top_k=1, opt_steps=12, beam_width=64, p_layers=2)
    jk = jplanner.KnobTuple(*knobs)
    for over in ({}, {"c_dispatch": 1e-3, "c_merge_base": 2e-4, "batch_slots": 128}):
        want = dataclasses.asdict(jplanner.CostModel.fit(rows, jk, **over))
        assert dataclasses.asdict(tplanner.CostModel.fit(rows, knobs, **over)) == want
        tagged = [dict(r, knobs=knobs._asdict()) for r in rows]
        assert dataclasses.asdict(tplanner.CostModel.fit(tagged, knobs, **over)) == want
    doubled = [dict(r, knobs=knobs._replace(opt_steps=25)._asdict()) for r in rows]
    half = tplanner.CostModel.fit(doubled, knobs, c_dispatch=0.0)
    full = tplanner.CostModel.fit(rows, knobs, c_dispatch=0.0)
    assert half.c_solve == pytest.approx(full.c_solve * 13 / 26, rel=1e-12)


def test_the_cards_prior_prices_the_solve():
    """On the committed calibration (phase 21a on the card: rows over T, p,
    N, K and W, and the fixed terms fitted there) the solve stage has a cost,
    and predicted cost rises with T, p and N."""
    model = tplanner.Planner().cost_model
    assert model.c_solve > 0
    with open(tplanner.DEFAULT_BENCH_PATH) as f:
        cal = json.load(f)
    seen = {(r["knobs"]["opt_steps"], r["knobs"]["p_layers"], r["knobs"]["n_qubits"],
             r["knobs"]["top_k"], r["knobs"]["beam_width"]) for r in cal["rows"]}
    assert {k[0] for k in seen} >= {4, 12, 30} and {k[1] for k in seen} >= {1, 2, 3}
    assert len({k[2] for k in seen}) >= 3 and set(cal["fixed"]) >= {"c_dispatch",
                                                                    "c_merge_base"}
    # the planner grid's K and W, so the merge's two terms fit apart
    assert {k[3] for k in seen} >= {1, 2, 4} and {k[4] for k in seen} >= {32, 128, 512}
    base = tplanner.KnobTuple(n_qubits=10, top_k=2, opt_steps=12, beam_width=128, p_layers=2)
    for field, lo, hi in (("opt_steps", 4, 30), ("p_layers", 1, 3), ("n_qubits", 8, 12)):
        a = model.predict(400, 8000, base._replace(**{field: lo})).solve_s
        b = model.predict(400, 8000, base._replace(**{field: hi})).solve_s
        assert b > a, (field, a, b)


def test_a_tighter_deadline_lowers_t_or_p():
    """At n = 400 and |E| = 8000, on the card's prior: a 0.05 s deadline is
    predicted to be met (the old prior predicted 0.110 s at best), and the
    tightest deadline any tuple of the grid meets gets fewer Adam steps or
    layers than a 2 s one. (On the card the top of the grid is predicted
    at about 35 ms, so 0.05 s binds no knob there.)"""
    planner = tplanner.Planner()
    tight = planner.plan(400, 8000, tplanner.SLA(deadline_s=0.05))
    assert tight.meets_deadline and tight.predicted.total_s <= 0.05
    floor = min(planner.cost_model.predict(400, 8000, kn).total_s for kn in planner.grid)
    tightest = planner.plan(400, 8000, tplanner.SLA(deadline_s=floor)).knobs
    loose = planner.plan(400, 8000, tplanner.SLA(deadline_s=2.0)).knobs
    assert (tightest.opt_steps, tightest.p_layers) != (loose.opt_steps, loose.p_layers)
    assert tightest.opt_steps <= loose.opt_steps and tightest.p_layers <= loose.p_layers


def _same_instance(j, t):
    jp = j if isinstance(j, jgraph.Problem) else jgraph.as_problem(j)
    tp = t if isinstance(t, tgraph.Problem) else tgraph.as_problem(t)
    assert type(j).__name__ == type(t).__name__
    assert (tp.n, tp.graph.n_edges, tp.offset, tp.kind) == (
        jp.n, jp.graph.n_edges, jp.offset, jp.kind)
    np.testing.assert_array_equal(np.asarray(tp.graph.edges), np.asarray(jp.graph.edges))
    np.testing.assert_array_equal(np.asarray(tp.graph.weights),
                                  np.asarray(jp.graph.weights))
    np.testing.assert_array_equal(np.asarray(tp.linear), np.asarray(jp.linear))


@pytest.mark.parametrize("problem,weights", [("maxcut", "unit"), ("maxcut", "spin"),
                                             ("qubo", "uniform"), ("mis", "unit")])
def test_request_mixes_equal_reference(problem, weights):
    args = (12, (20, 40), 0.2, 0.3, 5)
    jm = jwork.problem_mix(*args, problem=problem, weights=weights)
    tm = twork.problem_mix(*args, problem=problem, weights=weights)
    assert len(jm) == len(tm) == 12
    for j, t in zip(jm, tm):
        _same_instance(j, t)
    assert twork.tenant_mix(40, 3, 5) == jwork.tenant_mix(40, 3, 5)


def test_arrival_trace_equals_reference():
    kw = dict(deadline_choices=(0.5, 2.0, None), floor_choices=(None, 12.0))
    ja = jwork.arrival_trace(20, 4.0, (20, 40), 0.2, 6, **kw)
    ta = twork.arrival_trace(20, 4.0, (20, 40), 0.2, 6, **kw)
    for j, t in zip(ja, ta):
        assert (t.t, t.tenant, t.deadline_s, t.floor_quality) == (
            j.t, j.tenant, j.deadline_s, j.floor_quality)
        _same_instance(j.graph, t.graph)


def test_merge_stream_snapshots_equal_reference():
    n, k = 60, 2
    tg, jg = tgraph.Graph.erdos_renyi(n, 0.15, seed=30), jgraph.Graph.erdos_renyi(
        n, 0.15, seed=30)
    tp, jp = tpart.partition_for_solver(tg, 8), jpart.partition_for_solver(jg, 8)
    cand = np.random.default_rng(31).integers(0, 2 ** min(tp.sizes), (tp.m, k))
    tplan = tmerge.build_merge_plan(tp, cand, k)
    jplan = jmerge.build_merge_plan(jp, cand, k)
    for width in (4, 64):
        ts = list(tmerge.merge_stream(tplan, width))
        js = list(jmerge.merge_stream(jplan, width))
        assert len(ts) == len(js) == tp.m
        for a, b in zip(ts, js):
            assert (a.level, a.n_levels, a.cut_value, a.is_final) == (
                b.level, b.n_levels, b.cut_value, b.is_final)
            np.testing.assert_array_equal(a.assignment, np.asarray(b.assignment))
        # the final snapshot's frontier is the fully merged beam
        assert ts[-1].cut_value >= float(tmerge.merge_scan(tplan, width).cut_value) - 1e-3


class _Recording:
    """A backend wrapper that keeps every dispatch's rows and candidates."""

    def __init__(self, inner, to_np):
        self.inner, self.to_np, self.calls = inner, to_np, []

    def solve_batch(self, qcfg, edges, weights, masks, linears=None):
        res = self.inner.solve_batch(qcfg, edges, weights, masks, linears=linears)
        self.calls.append((qcfg, *map(self.to_np, (edges, weights, masks,
                                                   res.bitstrings))))
        return res

    def describe(self):
        return self.inner.describe()


GRID = [(6, 2, 0, 16), (8, 2, 0, 32)]


def _soak(side):
    """One virtual-clock soak of 14 arrivals with deadlines and floors."""
    if side == "jax":
        from repro.service.backend import LocalBackend
        pl, sch, wk, tracer_cls, to_np = (jplanner, jsched, jwork, JTracer, np.asarray)
        backend = _Recording(LocalBackend(), np.asarray)
    else:
        pl, sch, wk, tracer_cls = tplanner, tsched, twork, TTracer
        backend = _Recording(tbackend.LocalBackend(CPU), lambda x: x.numpy())
    clock = wk.VirtualClock()
    planner = pl.Planner(cost_model=pl.CostModel.from_bench_file(BENCH),
                         grid=[pl.KnobTuple(*g) for g in GRID], batch_slots=8)
    cfg = dict(batch_slots=8, max_qubits=8, max_inflight=2, recalibrate=False,
               tenant_max_slots=3)
    if side == "torch":
        cfg["device"] = CPU
    svc = sch.SolveService(sch.ServiceConfig(**cfg), planner=planner,
                           backend=backend, clock=clock,
                           tracer=tracer_cls(clock=clock, record=True))
    trace = wk.arrival_trace(14, 40.0, (20, 44), 0.2, 9, tenants=3,
                             deadline_choices=(0.02, 0.08, None),
                             floor_choices=(None, 9.0))
    rids = wk.run_soak_virtual(svc, clock, trace, tick_s=0.01)
    return svc, rids, backend


def test_scheduler_under_a_virtual_clock_equals_reference():
    jsvc, jrids, jb = _soak("jax")
    tsvc, trids, tb = _soak("torch")
    assert trids == jrids
    dispatch = [[s.attrs["rids"] for s in svc.trace.spans if s.name == "dispatch"]
                for svc in (jsvc, tsvc)]
    assert dispatch[1] == dispatch[0] and len(dispatch[0]) >= 3
    statuses = set()
    for rid in jrids:
        j, t = jsvc.results[rid], tsvc.results[rid]
        assert (t.status, t.cached, t.tenant, t.downgrades, t.deadline_met,
                t.latency_s) == (j.status, j.cached, j.tenant, j.downgrades,
                                 j.deadline_met, j.latency_s)
        assert (t.plan is None) == (j.plan is None)
        if t.plan is not None:
            _plans_equal(t.plan, j.plan)
        statuses.add(t.status)
    assert {"completed", "shed"} <= statuses
    jst, tst = jsvc.stats.as_dict(), tsvc.stats.as_dict()
    assert tst == jst
    assert tsvc.stats.downgrade_events + tsvc.stats.cache_served > 0
    # every dispatched row: the same candidates up to float64 ties
    assert len(tb.calls) == len(jb.calls)
    ties = 0
    for (qc, e, w, m, tbits), (_, _, _, jm, jbits) in zip(tb.calls, jb.calls):
        np.testing.assert_array_equal(m, jm)
        for r in np.flatnonzero(m > 1):
            if set(tbits[r]) == set(jbits[r]):
                continue
            n_real = int(m[r]).bit_length()
            sub = types.SimpleNamespace(edges=e[r], weights=w[r],
                                        n_edges=e.shape[1], n=n_real)
            marg = marginal64(sub, qc.n_qubits, p=qc.p_layers, delta=qc.ramp_delta)
            # both picks have the same float64 marginals: an exact tie
            for a, b in zip(sorted(tbits[r], key=lambda x: marg[x]),
                            sorted(jbits[r], key=lambda x: marg[x])):
                assert tie64(marg, int(a), int(b)), (r, tbits[r], jbits[r])
            ties += 1
    assert ties < sum(int((c[3] > 1).sum()) for c in tb.calls)


def _service(mesh=None, **kw):
    cfg = dict(batch_slots=8, max_qubits=8, max_inflight=2, recalibrate=False,
               mesh=mesh, device=CPU)
    cfg.update(kw)
    return tsched.SolveService(tsched.ServiceConfig(**cfg))


@pytest.mark.parametrize("problem", ["maxcut", "qubo", "mis"])
def test_service_equals_solo_solve_bitwise(problem):
    reqs = twork.problem_mix(5, (20, 44), 0.2, 0.25, 40, problem=problem,
                             weights="uniform" if problem == "maxcut" else "unit")
    svc = _service()
    rids = [svc.submit(r, tenant=f"t{i % 2}") for i, r in enumerate(reqs)]
    svc.drain()
    solved = 0
    for r, rid in zip(reqs, rids):
        res = svc.results[rid]
        assert res.status == "completed"
        if res.cached:
            continue
        solo = tpara.solve(r, res.plan.to_config(), device=CPU)
        assert res.cut_value == solo.cut_value
        np.testing.assert_array_equal(res.assignment, solo.assignment)
        solved += 1
    assert solved >= 3 and svc.stats.dispatches >= 2


def test_mesh_backend_equals_local_bitwise():
    reqs = twork.request_mix(6, (20, 44), 0.2, 0.25, seed=41)
    out = []
    for mesh in (None, "data=4"):
        svc = _service(mesh)
        rids = [svc.submit(g) for g in reqs]
        svc.drain()
        out.append([svc.results[r] for r in rids])
        if mesh:
            assert svc.backend.describe() == {"backend": "mesh", "mesh": {"data": 4},
                                              "axes": ["data"], "devices": 4}
    for a, b in zip(*out):
        assert a.cut_value == b.cut_value and a.cached == b.cached
        np.testing.assert_array_equal(a.assignment, b.assignment)


def test_streamed_request_snapshots():
    g = twork.request_mix(1, (40, 44), 0.2, 0.0, seed=42)[0]
    svc = _service(enable_cache=False)
    seen = []
    rid = svc.submit(g, stream=True, on_update=lambda *a: seen.append(a))
    svc.drain()
    res = svc.results[rid]
    m = tpart.partition_for_solver(g, res.plan.knobs.n_qubits).m
    assert [s[1] for s in seen] == list(range(1, m + 1))
    cuts = [s[3] for s in seen]
    assert cuts == sorted(cuts) and cuts[-1] == res.cut_value
    assert float(tgraph.problem_value(tgraph.as_problem(g),
                                      torch.as_tensor(res.assignment))) == res.cut_value


def test_solve_subgraph_batch_reads_nothing_back(monkeypatch):
    """No host read between the first launch and the return: with every
    tensor-to-host method raising, the call still completes; the masks
    come as the host copy the packer made."""
    g = tgraph.Graph.erdos_renyi(30, 0.3, seed=43)
    part = tpart.partition_for_solver(g, 6)
    edges, weights, masks = tqaoa.pad_subgraph_arrays(part.subgraphs, 6, n_rows=8)
    host_masks = masks.numpy()
    cfg = tqaoa.QAOAConfig(n_qubits=6, p_layers=2, opt_steps=2, top_k=2)
    want = tqaoa.solve_subgraph_batch(edges, weights, host_masks, cfg)

    def refuse(*_a, **_k):
        raise AssertionError("host read of a tensor inside the solve")

    for name in ("tolist", "item", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = tqaoa.solve_subgraph_batch(edges, weights, host_masks, cfg)
    monkeypatch.undo()
    assert torch.equal(got.bitstrings, want.bitstrings)
    assert torch.equal(got.expectation, want.expectation)


def test_the_service_prepares_every_bucket_its_grid_reaches():
    """A backend that graphs its buckets gets, when the service is built,
    every (QAOAConfig, edge capacity, linear or not) a plan of the
    planner's grid can fill, at the configured rows; the CPU's local
    backend captures nothing."""
    calls = []

    class Recording(tbackend.LocalBackend):
        def prepare(self, buckets, rows):
            calls.append((list(buckets), rows))
            return super().prepare(buckets, rows)

    svc = tsched.SolveService(tsched.ServiceConfig(batch_slots=8, max_qubits=10, device=CPU),
                              backend=Recording(CPU))
    (buckets, rows), = calls
    assert rows == 8
    want = {(kn.n_qubits, kn.opt_steps, kn.p_layers, kn.top_k) for kn in svc.planner.grid}
    assert {(q.n_qubits, q.opt_steps, q.p_layers, q.top_k) for q, _, _ in buckets} == want
    assert len(buckets) == 2 * len(want) == len(set(buckets))
    assert all(e_pad == tsched.edge_capacity(q.n_qubits) for q, e_pad, _ in buckets)
    assert {lin for _, _, lin in buckets} == {False, True}
    assert tbackend.LocalBackend(CPU).prepare(buckets, rows) == 0
    assert tbackend.graph_count() == 0


def test_set_aside_takes_a_blocks_counts_out():
    """`_build.set_aside_launches` and the ledger's `set_aside_ops` leave the
    counters as they were before the block and hand over what it counted;
    `add_launches` / `add_ops` count it back (a graph's replay)."""
    from repro_torch.kernels import _build
    from repro_torch.obs.ledger import get_ledger

    ledger = get_ledger()
    _build.reset_launches()
    ledger.reset()
    _build.count_launch("cutvals")
    ledger.note_op("cutvals", "cuda")
    with _build.set_aside_launches() as launched, ledger.set_aside_ops() as noted:
        _build.count_launch("cutvals")
        _build.count_launch("beta_grad")
        _build.count_launch("beta_grad")
        ledger.note_op("apply_layer", "cuda")
    assert launched == {"cutvals": 1, "beta_grad": 2}
    assert noted == {("apply_layer", "cuda"): 1}
    assert _build.launches == {"cutvals": 1}
    assert ledger.op_traces == {("cutvals", "cuda"): 1}
    _build.add_launches(launched)
    ledger.add_ops(noted)
    assert _build.launches == {"cutvals": 2, "beta_grad": 2}
    assert ledger.op_traces == {("cutvals", "cuda"): 1, ("apply_layer", "cuda"): 1}
    _build.reset_launches()
    ledger.reset()


def _key_now(qcfg, device="cuda", rows=128, e_pad=40, linear=False):
    """A bucket's graph key under the tuning state of the moment, read as
    `solve_graphed` and `LocalBackend.prepare` read it."""
    from repro_torch.kernels import tuning

    return tbackend._graph_key(qcfg, device, rows, e_pad, linear, tuning.state())


def test_graph_key_carries_the_tuning_state():
    """A graph captured under one tuning state is never the graph of
    another: the key changes with `tuning.using_overrides` and with
    `tuning.set_enabled`, and comes back with them."""
    from repro_torch.kernels import tuning

    qcfg = tqaoa.QAOAConfig(n_qubits=12, p_layers=3, opt_steps=30)
    base = _key_now(qcfg)
    table = {tuning.cache_key("expectation", 2**12): {"tile": 512}}
    with tuning.using_overrides(table):
        tuned = _key_now(qcfg)
        with tuning.using_overrides({tuning.cache_key("expectation", 2**12): {"tile": 256}}):
            other = _key_now(qcfg)
    tuning.set_enabled(True)
    try:
        committed = _key_now(qcfg)
    finally:
        tuning.set_enabled(False)
    keys = [base, tuned, other, committed]
    assert len(set(keys)) == len(keys)
    assert _key_now(qcfg) == base
    assert base[-1] == ("off",) and committed[-1][0] == "on"


def test_capture_runs_under_the_keyed_state(monkeypatch):
    """`_capture` re-asserts the state its key names: every warm-up and the
    capture itself see the keyed tuning state and tile (through a
    recording `tuning.param`), whatever the caller's state,
    and the caller's state comes back afterwards. The CUDA stream and
    graph calls are stubbed (the CPU has none)."""
    import contextlib

    from repro_torch.kernels import tuning

    seen = []
    real_param = tuning.param

    def recording_param(op, dim, name, default, device="cuda"):
        value = real_param(op, dim, name, default, device)
        seen.append((op, name, value))
        return value

    def fake_solve(edges, weights, cfg, linear=None):
        tile = tuning.param("expectation", 2**cfg.n_qubits, "tile", 1024, "cuda")
        seen.append(("state", tuning.state(), tile))
        z = torch.zeros(edges.shape[0])
        return z, z, z, z, z

    class _Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(tuning, "param", recording_param)
    monkeypatch.setattr(tqaoa, "solve_batch_on_device", fake_solve)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())

    qcfg = tqaoa.QAOAConfig(n_qubits=12)
    edges = torch.zeros((4, 6, 2), dtype=torch.int32)
    weights = torch.zeros((4, 6))
    key = tuning.cache_key("expectation", 2**12)
    with tuning.using_overrides({key: {"tile": 256}}):
        keyed = tuning.state()
    with tuning.using_overrides({key: {"tile": 512}}):  # the caller's state differs
        caller = tuning.state()
        g = tbackend._capture(qcfg, edges, weights, None, keyed)
        assert tuning.state() == caller
    assert tuning.state() == ("off",)
    states = [x for x in seen if x[0] == "state"]
    assert len(states) == tbackend.GRAPH_WARMUP + 1
    assert all(x == ("state", keyed, 256) for x in states)
    assert ("expectation", "tile", 256) in seen
    assert isinstance(g, tbackend._Graph)


def test_backend_launch_bookkeeping_goes_through_ops():
    """The service's backend counts a replay's launches through
    `kernels.ops`, the dispatch boundary, not the build module."""
    from repro_torch.kernels import _build, ops

    assert not hasattr(tbackend, "_build")
    ops.reset_launch_counts()
    with ops.set_aside_launches() as launched:
        _build.count_launch("expectation")
    assert launched == {"expectation": 1} and ops.launch_counts()["expectation"] == 0
    ops.add_launches(launched)
    assert ops.launch_counts()["expectation"] == 1
    ops.reset_launch_counts()


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_pad_fold_is_independent_of_the_rows_beside_it(rows):
    """`fold_pad_bits`: a row folded alone and among other rows, bitwise."""
    x = torch.from_numpy(np.random.default_rng(44).random((8, 2**8), dtype=np.float32))
    for n_real in (1, 3, 8):
        alone = torch.cat([tqaoa.fold_pad_bits(x[r:r + 1], n_real) for r in range(rows)])
        assert torch.equal(tqaoa.fold_pad_bits(x[:rows], n_real), alone)
        np.testing.assert_allclose(
            alone.numpy(), x[:rows].reshape(rows, -1, 2**n_real).sum(1).numpy(),
            rtol=1e-6)


def test_service_mesh_check_is_all_true(capsys):
    """``python -m repro_torch.core._dist_checks service_mesh --device cpu``:
    the reference's keys, every value true."""
    from repro_torch.core import _dist_checks

    result = _dist_checks.main(["service_mesh", "--device", "cpu"])
    assert set(result) == {"backends_parity", "solo_parity", "mesh_backend_engaged",
                           "tenants_accounted", "async_window_used"}
    assert all(v is True for v in result.values()), result
    assert capsys.readouterr().out.strip().startswith("{")
