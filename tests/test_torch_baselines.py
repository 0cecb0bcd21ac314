"""The port's baselines and the rest of its core API against the JAX
package's, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
What each comparison holds, and why:

- `refine` and `local_search` on integer weights (unit, ±1 spin, integer
  linear terms): every gain is an exact integer in f32 in any order of
  addition, so the flips and the re-scored values are equal;
- `refine` on real weights: the port sums each vertex's gains along its
  incidence row, the reference scatter-adds them, so a gain may differ in
  its last ulp. Step by step from the same state, the port's flip equals
  the reference's, or the two vertices' gains tie in float64; the final
  value lies within ``1e-5·Σ|w|`` of the reference's;
- the brute-force oracles on integer and dyadic objectives: value and
  assignment exactly equal, across chunk boundaries;
- GW from the same numpy start ``x0`` and hyperplanes ``h``: the vectors
  within ``GW_ATOL`` (f32 sums in another order, over 20 normalised
  steps), the rounding equal wherever |x·h| ≥ 1e-6; the whole GW (its
  draws cannot equal ``jax.random``'s) within ``GW_BAND`` of Σ|w| of the
  reference and at or above 0.878 of the exact optimum;
- QAOA²: `_contract` exactly equal; at ``opt_steps = 0`` every subgraph's
  top-1 equal or a float64 tie of the marginals, and the cut equal where
  all are equal; at the default 30 steps within ``BAND`` of Σ|w|;
- partition and graph helpers: numpy work in both packages, equal.

A tie is decided in float64 (`marginal64`, `gains64`), never by widening
an f32 tolerance: the f32 gap between a tie's two sides has reached
1.66e-6 relative.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core import qaoa as jqaoa
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import partition as tpart
from repro_torch.core import qaoa as tqaoa

# the modules, not the functions of the same name that `baselines` exports
jbf, jgw, jls, jq2, tbf, tgw, tls, tq2 = (
    importlib.import_module(f"{pkg}.core.baselines.{mod}")
    for pkg in ("repro", "repro_torch")
    for mod in ("brute_force", "gw", "local_search", "qaoa_in_qaoa"))

BAND = 0.02
GW_BAND = 0.02
GW_ATOL = 1e-5
TIE64_RTOL = 1e-12
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _pair(kind, n, p, seed):
    gen = {"unit": "erdos_renyi", "uniform": "erdos_renyi_weighted",
           "spin": "spin_glass"}[kind]
    return (getattr(jgraph.Graph, gen)(n, p, seed=seed),
            getattr(tgraph.Graph, gen)(n, p, seed=seed))


def gains64(graph, s, linear=None):
    """The 1-flip gains of the assignment ``s``, in float64."""
    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights, dtype=np.float64)[: graph.n_edges]
    s = np.asarray(s, dtype=np.int64)
    crossed = (s[e[:, 0]] ^ s[e[:, 1]]).astype(np.float64)
    deg = np.zeros(graph.n)
    inc = np.zeros(graph.n)
    for col in (0, 1):
        np.add.at(deg, e[:, col], w)
        np.add.at(inc, e[:, col], w * crossed)
    g = deg - 2.0 * inc
    if linear is not None:
        g += np.asarray(linear, dtype=np.float64) * (1.0 - 2.0 * s)
    return g


def marginal64(sub, n_qubits, p=3, delta=0.75):
    """One padded subgraph's QAOA marginal over its real qubits at the
    linear-ramp angles, simulated in float64: the arbiter of ties. The
    angles are the packages' own f32 ramp values."""
    n = n_qubits
    x = np.arange(2**n)
    e = np.asarray(sub.edges)[: sub.n_edges]
    w = np.asarray(sub.weights, dtype=np.float64)[: sub.n_edges]
    c = np.zeros(2**n)
    for (u, v), wt in zip(e, w):
        c += wt * (((x >> u) ^ (x >> v)) & 1)
    lvl = (np.arange(p, dtype=np.float32) + np.float32(0.5)) / np.float32(p)
    gammas = np.float32(delta) * lvl
    betas = np.float32(delta) * (np.float32(1.0) - lvl)
    psi = np.full(2**n, 2.0 ** (-n / 2), dtype=np.complex128)
    for g, b in zip(gammas.astype(np.float64), betas.astype(np.float64)):
        psi = psi * np.exp(-1j * g * c)
        for q in range(n):
            t = psi.reshape(-1, 2, 2**q)
            a0, a1 = t[:, 0].copy(), t[:, 1].copy()
            t[:, 0] = np.cos(b) * a0 - 1j * np.sin(b) * a1
            t[:, 1] = np.cos(b) * a1 - 1j * np.sin(b) * a0
            psi = t.reshape(-1)
    return np.bincount(x & (2**sub.n - 1), np.abs(psi) ** 2, minlength=2**n)


def tie64(marg, a, b):
    return abs(marg[a] - marg[b]) <= TIE64_RTOL * max(marg[a], marg[b])


# ---------------------------------------------------------------------------
# refine and local_search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unit", "spin"])
@pytest.mark.parametrize("with_linear", [False, True])
def test_refine_equal_on_integer_weights(kind, with_linear):
    jg, tg = _pair(kind, 40, 0.2, 3)
    rng = np.random.default_rng(4)
    a0 = rng.integers(0, 2, 40).astype(np.int8)
    lin = rng.integers(-3, 4, 40).astype(np.float32) if with_linear else None
    ja, jv = jls.refine(jg, a0, 60, linear=lin)
    ta, tv = tls.refine(tg, a0, 60, linear=lin, device=CPU)
    _eq(ta, ja)
    assert tv == jv
    assert ta.dtype == np.int8 and (ta != a0).any()


def test_refine_real_weights_flips_equal_up_to_float64_ties():
    jg, tg = _pair("uniform", 40, 0.2, 5)
    s = np.random.default_rng(6).integers(0, 2, 40).astype(np.int8)
    for _ in range(50):
        js, _ = jls.refine(jg, s, 1)
        ts, _ = tls.refine(tg, s, 1, device=CPU)
        if not np.array_equal(js, ts):
            g = gains64(tg, s)
            flipped = [int(np.flatnonzero(x != s)[0]) for x in (js, ts)
                       if (x != s).any()]
            assert len(flipped) == 2 and g[flipped[0]] == pytest.approx(
                g[flipped[1]], rel=TIE64_RTOL), (flipped, g[flipped])
        s = js
    _, jv = jls.refine(jg, s * 0, 80)
    _, tv = tls.refine(tg, s * 0, 80, device=CPU)
    assert abs(tv - jv) <= 1e-5 * float(tg.weights.abs().sum()), (tv, jv)


def test_refine_relative_epsilon_accepts_tiny_weights():
    """The reference's PR 10 case: uniformly tiny weights, where every real
    gain is below an absolute 1e-6."""
    n = 6
    e = np.array([[0, i] for i in range(1, n)], dtype=np.int32)  # a star
    w = np.full(n - 1, 1e-8, dtype=np.float32)
    a0 = np.zeros(n, dtype=np.int8)  # cut 0; flipping the hub gains 5e-8
    a, v = tls.refine(tgraph.Graph.from_edges(n, e, w), a0, 5, device=CPU)
    ja, jv = jls.refine(jgraph.Graph.from_edges(n, e, w), a0, 5)
    assert v == pytest.approx(5e-8, rel=1e-3)
    _eq(a, ja)
    assert v == jv


def test_refine_rescore_no_drift():
    """The reference's PR 10 case: after 400 steps on a weighted instance
    the value is the from-scratch cut of the assignment, exactly."""
    jg, tg = (cls.erdos_renyi_weighted(120, 0.2, seed=25, low=0.01, high=3.0)
              for cls in (jgraph.Graph, tgraph.Graph))
    a0 = np.zeros(120, dtype=np.int8)
    a, v = tls.refine(tg, a0, 400, device=CPU)
    assert v == float(tgraph.cut_value(tg, torch.as_tensor(a)))
    ja, jv = jls.refine(jg, a0, 400)
    assert abs(v - jv) <= 1e-5 * float(tg.weights.abs().sum()), (v, jv)


def test_refine_with_linear_clears_mis_violations():
    g = tgraph.Graph.erdos_renyi(30, 0.25, seed=26)
    prob = tgraph.Problem.mis(g)
    a, v = tls.refine(prob.graph, np.ones(30, dtype=np.int8), 120,
                      linear=prob.linear, device=CPU)
    assert tgraph.independent_set_violations(g, a) == 0
    assert v == pytest.approx(float(tgraph.problem_value(prob, torch.as_tensor(a)))
                              - prob.offset)


@pytest.mark.parametrize("kind", ["unit", "spin"])
def test_local_search_equal_on_integer_weights(kind):
    jg, tg = _pair(kind, 50, 0.15, 8)
    js, jv, _ = jls.local_search(jg, restarts=3, steps=80, seed=2)
    ts, tv, rep = tls.local_search(tg, restarts=3, steps=80, seed=2, device=CPU)
    _eq(ts, js)
    assert tv == jv and rep.method == "local_search" and rep.cut_value == tv


def test_solve_refined_equals_refine_of_the_unrefined_solve():
    g = tgraph.Graph.erdos_renyi_weighted(40, 0.25, seed=9)
    cfg = tpara.ParaQAOAConfig(n_qubits=8, opt_steps=3)
    out0 = tpara.solve(g, cfg, device=CPU)
    out = tpara.solve(g, tpara.ParaQAOAConfig(n_qubits=8, opt_steps=3,
                                              refine_steps=40), device=CPU)
    a, v = tls.refine(g, out0.assignment, 40, device=CPU)
    _eq(out.assignment, a)
    assert out.cut_value == pytest.approx(v, abs=1e-4)
    assert out.cut_value >= out0.cut_value - 1e-4
    assert set(out.timings) == {"partition_s", "solve_s", "merge_s", "refine_s",
                                "total_s"}
    _eq(out.candidates, out0.candidates)


def test_solve_distributed_refined_equals_flat_refine_of_its_merge():
    g = tgraph.Graph.erdos_renyi(40, 0.25, seed=10)
    prob = tgraph.Problem.mis(g)
    base = dict(n_qubits=6, opt_steps=2, sharded_opt_steps=1)
    axis = tdist.LocalAxis(2)
    out0 = tdist.solve_distributed(prob, tpara.ParaQAOAConfig(**base), axis,
                                   device=CPU)
    out = tdist.solve_distributed(prob, tpara.ParaQAOAConfig(**base, refine_steps=30),
                                  axis, device=CPU)
    assert out.report.extra["sharded_subproblems"] > 0
    a, v = tls.refine(prob.graph, out0.assignment, 30, linear=prob.linear.numpy(),
                      device=CPU)
    _eq(out.assignment, a)
    assert out.cut_value == pytest.approx(v + prob.offset, abs=1e-4)
    assert "refine_s" in out.timings


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------

def _integer_qubo(n, seed):
    """A QUBO with integer coefficients: every objective value is a dyadic
    sum, exact in f32 in any order."""
    g = jgraph.Graph.erdos_renyi(n, 0.4, seed=seed)
    e = np.asarray(g.edges)[: g.n_edges]
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, g.n_edges).astype(np.float32)
    h = rng.integers(-3, 4, n).astype(np.float32)
    return (jgraph.Problem.qubo(n, e, q, linear=h, offset=1.5),
            tgraph.Problem.qubo(n, e, q, linear=h, offset=1.5))


@pytest.mark.parametrize("kind", ["unit", "spin"])
@pytest.mark.parametrize("n,chunk", [(9, 22), (14, 22), (14, 9)])
def test_brute_force_maxcut_equal(kind, n, chunk):
    jg, tg = _pair(kind, n, 0.4, n)
    ja, jv, _ = jbf.brute_force_maxcut(jg, chunk_qubits=chunk)
    ta, tv, rep = tbf.brute_force_maxcut(tg, chunk_qubits=chunk, device=CPU)
    _eq(ta, ja)
    assert tv == jv and rep.cut_value == tv and ta.dtype == np.int8
    assert float(tgraph.cut_value(tg, torch.as_tensor(ta))) == tv


@pytest.mark.parametrize("family", ["maxcut", "qubo", "mis"])
@pytest.mark.parametrize("chunk", [22, 10])
def test_brute_force_problem_equal(family, chunk):
    n = 14
    if family == "qubo":
        jp, tp = _integer_qubo(n, 12)
    else:
        jg, tg = _pair("unit", n, 0.3, 13)
        jp, tp = ((jgraph.Problem.mis(jg), tgraph.Problem.mis(tg)) if family == "mis"
                  else (jg, tg))
    ja, jv, _ = jbf.brute_force_problem(jp, chunk_qubits=chunk)
    ta, tv, _ = tbf.brute_force_problem(tp, chunk_qubits=chunk, device=CPU)
    _eq(ta, ja)
    assert tv == jv
    prob = tgraph.as_problem(tp)
    assert float(tgraph.problem_value(prob, torch.as_tensor(ta))) == tv


def test_brute_force_real_weights_equal_up_to_float64_ties():
    jg, tg = _pair("uniform", 13, 0.4, 14)
    ja, jv, _ = jbf.brute_force_maxcut(jg, chunk_qubits=6)
    ta, tv, _ = tbf.brute_force_maxcut(tg, chunk_qubits=6, device=CPU)
    assert tv == pytest.approx(jv, rel=1e-6)
    if not np.array_equal(ta, ja):
        e = np.asarray(tg.edges)[: tg.n_edges]
        w = np.asarray(tg.weights, dtype=np.float64)[: tg.n_edges]
        cut = [float(w @ (a[e[:, 0]] ^ a[e[:, 1]])) for a in (ta, ja)]
        assert cut[0] == pytest.approx(cut[1], rel=TIE64_RTOL)


def test_brute_force_limits():
    with pytest.raises(ValueError):
        tbf.brute_force_maxcut(tgraph.Graph.from_edges(31, [(0, 1)]), device=CPU)
    with pytest.raises(ValueError):
        tbf.brute_force_problem(tgraph.Graph.from_edges(27, [(0, 1)]), device=CPU)


# ---------------------------------------------------------------------------
# Goemans–Williamson
# ---------------------------------------------------------------------------

def _gw_start(n, r, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, r)).astype(np.float32)
    return x0 / np.linalg.norm(x0, axis=1, keepdims=True)


def test_bm_optimize_matches_jax_from_the_same_start():
    jg, tg = _pair("uniform", 40, 0.3, 15)
    r = 9
    x0 = _gw_start(40, r, 16)
    jx = np.asarray(jgw._bm_optimize(jg.edges, jg.weights, jnp.asarray(x0), 40, 20,
                                     0.05))
    tx = tgw._bm_optimize(tgraph.incidence(tg), torch.as_tensor(x0), 20, 0.05).numpy()
    np.testing.assert_allclose(tx, jx, atol=GW_ATOL, rtol=0)

    def objective(x):
        e = np.asarray(tg.edges)[: tg.n_edges]
        w = np.asarray(tg.weights, dtype=np.float64)[: tg.n_edges]
        dots = np.sum(x[e[:, 0]].astype(np.float64) * x[e[:, 1]], axis=1)
        return float(np.sum(w * (1.0 - dots) / 2.0))

    assert objective(tx) == pytest.approx(objective(jx), rel=1e-5)
    assert objective(tx) > objective(x0)


def test_round_hyperplanes_matches_jax_off_the_planes():
    x = _gw_start(40, 9, 17)
    h = np.random.default_rng(18).standard_normal((16, 9)).astype(np.float32)
    jsigns = np.asarray((jnp.asarray(x) @ jnp.asarray(h).T >= 0.0).T.astype(jnp.int8))
    tsigns = tgw._round_hyperplanes(torch.as_tensor(x), torch.as_tensor(h)).numpy()
    clear = np.abs(x.astype(np.float64) @ h.T.astype(np.float64)).T >= 1e-6
    _eq(tsigns[clear], jsigns[clear])
    assert tsigns.dtype == np.int8 and tsigns.shape == (16, 40)


def test_goemans_williamson_within_band_and_above_the_guarantee():
    jg, tg = _pair("unit", 14, 0.4, 19)
    _, jv, _ = jgw.goemans_williamson(jg)
    ta, tv, rep = tgw.goemans_williamson(tg, device=CPU)
    _, opt, _ = tbf.brute_force_maxcut(tg, device=CPU)
    assert abs(tv - jv) <= GW_BAND * float(tg.weights.abs().sum()), (tv, jv)
    assert tv >= 0.878 * opt, (tv, opt)
    assert float(tgraph.cut_value(tg, torch.as_tensor(ta))) == tv
    assert rep.extra == {"rank": 6, "steps": 300, "rounds": 64}


# ---------------------------------------------------------------------------
# QAOA²
# ---------------------------------------------------------------------------

Q2_N, Q2_QUBITS = 60, 10  # G(60, 0.3): 7 subgraphs, a 7-node signed contraction


def test_contract_equal_and_signed():
    jg, tg = _pair("unit", Q2_N, 0.3, 0)
    part = tpart.connectivity_preserving_partition(tg, 7)
    rng = np.random.default_rng(20)
    bits = [rng.integers(0, 2, s).astype(np.int8) for s in part.sizes]
    jc, jsb = jq2._contract(jg, part.ranges, bits)
    tc, tsb = tq2._contract(tg, part.ranges, bits)
    _eq(tsb, jsb)
    assert (tc.n, tc.n_edges) == (jc.n, jc.n_edges)
    _eq(tc.edges, jc.edges)
    _eq(tc.weights, jc.weights)
    assert float(tc.weights.min()) < 0, "no negative contracted weight"


def _top1(qaoa_mod, subgraphs, **kw):
    """Each subgraph's top-1 basis index at ``opt_steps = 0``."""
    cfg = qaoa_mod.QAOAConfig(n_qubits=Q2_QUBITS, opt_steps=0, top_k=1)
    res = qaoa_mod.solve_subgraph_batch(
        *qaoa_mod.pad_subgraph_arrays(subgraphs, Q2_QUBITS, **kw), cfg)
    return np.asarray(res.bitstrings)[:, 0].astype(np.int64)


def test_qaoa_in_qaoa_equal_at_zero_steps_up_to_float64_ties():
    """Each stage of QAOA² from the same inputs: every subgraph's top-1, then
    the orientation solve of the signed contraction of the reference's
    local bits; equal, or a float64 tie of the marginals. Where every stage
    is equal, so are the assignment and the cut."""
    jg, tg = _pair("unit", Q2_N, 0.3, 0)
    ja, jv, _ = jq2.qaoa_in_qaoa(jg, n_qubits=Q2_QUBITS, opt_steps=0)
    ta, tv, rep = tq2.qaoa_in_qaoa(tg, n_qubits=Q2_QUBITS, opt_steps=0, device=CPU)
    assert rep.method == "qaoa_in_qaoa" and rep.cut_value == tv
    assert float(tgraph.cut_value(tg, torch.as_tensor(ta))) == tv
    m = int(np.ceil(Q2_N / (Q2_QUBITS - 1)))
    part = tpart.connectivity_preserving_partition(tg, m)
    jidx = _top1(jqaoa, jpart.connectivity_preserving_partition(jg, m).subgraphs)
    tidx = _top1(tqaoa, part.subgraphs)
    differ = [i for i in range(part.m) if tidx[i] != jidx[i]]
    for i in differ:
        assert tie64(marginal64(part.subgraphs[i], Q2_QUBITS), tidx[i], jidx[i]), (
            i, tidx[i], jidx[i])
    bits = [((int(jidx[i]) >> np.arange(s)) & 1).astype(np.int8)
            for i, s in enumerate(part.sizes)]
    contracted, _ = tq2._contract(tg, part.ranges, bits)
    assert float(contracted.weights.min()) < 0, "no negative contracted weight"
    jcfg = jqaoa.QAOAConfig(n_qubits=Q2_QUBITS, opt_steps=0, top_k=1)
    tcfg = tqaoa.QAOAConfig(n_qubits=Q2_QUBITS, opt_steps=0, top_k=1)
    jz = jq2._solve_orientation(jq2._contract(jg, part.ranges, bits)[0], Q2_QUBITS, jcfg)
    tz = tq2._solve_orientation(contracted, Q2_QUBITS, tcfg, CPU)
    z = [int(np.sum(x.astype(np.int64) << np.arange(m))) for x in (tz, jz)]
    assert z[0] == z[1] or tie64(marginal64(contracted, Q2_QUBITS), *z), z
    if not differ and z[0] == z[1]:
        _eq(ta, ja)
        assert tv == jv


def test_qaoa_in_qaoa_within_band_at_default_steps():
    jg, tg = _pair("unit", Q2_N, 0.3, 0)
    _, jv, _ = jq2.qaoa_in_qaoa(jg, n_qubits=Q2_QUBITS)
    ta, tv, _ = tq2.qaoa_in_qaoa(tg, n_qubits=Q2_QUBITS, device=CPU)
    assert abs(tv - jv) <= BAND * float(tg.weights.abs().sum()), (tv, jv)
    assert float(tgraph.cut_value(tg, torch.as_tensor(ta))) == tv


def test_marginal64_agrees_with_the_port():
    """The float64 arbiter simulates the same circuit as the port."""
    g = tgraph.Graph.erdos_renyi(8, 0.5, seed=21)
    e, w, m = tqaoa.pad_subgraph_arrays([g], Q2_QUBITS)
    g0, b0 = tqaoa.linear_ramp_init(3, 0.75)
    from repro_torch.kernels import ops

    re, im = tqaoa.qaoa_statevector(ops.cutvals(Q2_QUBITS, e, w), Q2_QUBITS,
                                    g0[None], b0[None])
    probs = (re * re + im * im)[0].numpy().astype(np.float64)
    port = np.bincount(np.arange(2**Q2_QUBITS) & int(m[0]), probs,
                       minlength=2**Q2_QUBITS)
    np.testing.assert_allclose(marginal64(g, Q2_QUBITS), port, atol=1e-6)


# ---------------------------------------------------------------------------
# the rest of core's public API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(400, 16), (37, 5), (10, 1)])
def test_alg1_ranges_equal(n, m):
    assert tpart.alg1_ranges(n, m) == jpart.alg1_ranges(n, m)
    assert tpart._contiguous_ranges(n, m, exact_alg1=True) == \
        jpart._contiguous_ranges(n, m, exact_alg1=True)
    assert tpart._contiguous_ranges(n, m) == jpart._contiguous_ranges(n, m)


def test_alg1_ranges_rejects_tiny_parts():
    for mod in (tpart, jpart):
        with pytest.raises(ValueError):
            mod.alg1_ranges(5, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_partition_equal(seed):
    jg, tg = _pair("uniform", 33, 0.3, seed)
    jp, tp = jpart.random_partition(jg, 4, seed), tpart.random_partition(tg, 4, seed)
    assert jp.ranges == tp.ranges and jp.sizes == tp.sizes
    _eq(jp.graph.edges, tp.graph.edges)
    _eq(jp.graph.weights, tp.graph.weights)
    for a, b in zip(jp.subgraphs, tp.subgraphs):
        _eq(a.edges, b.edges)
        _eq(a.weights, b.weights)
    _eq(jp.inter_edges, tp.inter_edges)
    _eq(jp.inter_weights, tp.inter_weights)


def test_stitch_assignments_equal():
    jg, tg = _pair("unit", 30, 0.3, 2)
    jp, tp = jpart.partition_for_solver(jg, 8), tpart.partition_for_solver(tg, 8)
    rng = np.random.default_rng(22)
    bits = [rng.integers(0, 2, s + 2).astype(np.int8) for s in tp.sizes]
    out = tpart.stitch_assignments(tp, bits)
    _eq(out, jpart.stitch_assignments(jp, bits))
    assert out.dtype == np.int8


@pytest.mark.parametrize("kind", ["unit", "spin", "uniform"])
def test_degree_and_subgraph_equal(kind):
    jg, tg = _pair(kind, 30, 0.3, 3)
    jd, td = np.asarray(jg.degree()), tg.degree().numpy()
    if kind == "uniform":  # real weights summed in another order
        np.testing.assert_allclose(td, jd, rtol=1e-6)
    else:
        _eq(td, jd)
    for lo, hi, pad in ((0, 10, None), (7, 30, 120)):
        a, b = jgraph.subgraph(jg, lo, hi, pad_to=pad), tgraph.subgraph(tg, lo, hi, pad_to=pad)
        assert (a.n, a.n_edges) == (b.n, b.n_edges)
        _eq(a.edges, b.edges)
        _eq(a.weights, b.weights)


def test_incidence_rows_hold_each_vertex_edges_in_scatter_order():
    g = tgraph.Graph.from_edges(4, [(0, 1), (2, 0), (1, 2), (0, 3)],
                                [1.0, 2.0, 3.0, 4.0], pad_to=6)
    inc = tgraph.incidence(g)
    _eq(inc.nbr, [[1, 3, 2], [2, 0, 0], [0, 1, 0], [0, 0, 0]])
    _eq(inc.weight, [[1.0, 4.0, 2.0], [3.0, 1.0, 0.0], [2.0, 3.0, 0.0],
                     [4.0, 0.0, 0.0]])
    empty = tgraph.incidence(tgraph.Graph.from_edges(3, []))
    assert tuple(empty.nbr.shape) == (3, 1) and float(empty.weight.abs().sum()) == 0


def test_networkx_to_graph_equal():
    nx = pytest.importorskip("networkx")
    h = nx.gnp_random_graph(12, 0.4, seed=3)
    for u, v in h.edges:
        h[u][v]["weight"] = float(u + v)
    a, b = jgraph.networkx_to_graph(h), tgraph.networkx_to_graph(h)
    _eq(a.edges, b.edges)
    _eq(a.weights, b.weights)


def test_core_exports_random_partition():
    import repro.core as jcore
    import repro_torch.core as tcore
    import repro_torch.core.baselines as tbase
    from repro.core import baselines as jbase

    assert tcore.random_partition is tpart.random_partition
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert tbase.__all__ == jbase.__all__


def test_baselines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g = tgraph.Graph.erdos_renyi(10, 0.3, seed=0)
    for call in (lambda: tls.refine(g, np.zeros(10, np.int8), 2),
                 lambda: tls.local_search(g, restarts=1, steps=2),
                 lambda: tbf.brute_force_maxcut(g),
                 lambda: tbf.brute_force_problem(g),
                 lambda: tgw.goemans_williamson(g, steps=2),
                 lambda: tq2.qaoa_in_qaoa(g, n_qubits=10, opt_steps=0)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
