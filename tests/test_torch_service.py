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
    want = tplanner.CostModel.from_bench_file(tplanner.DEFAULT_BENCH_PATH)
    assert tplanner.Planner().base_model == want


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
