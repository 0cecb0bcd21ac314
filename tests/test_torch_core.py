"""The port's core modules against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages as the same arrays.
What each comparison holds, and why:

- graphs, problems, partitions, padded batches and merge plans are numpy
  work in both packages: equal element for element;
- the merge fed the JAX solver's own candidates: the identical assignment
  and score where weights are integers (exact f32 sums), within ``1e-5``
  relative otherwise (f32 sums in another order);
- QAOA at fixed angles: states ``atol 2e-5``, ⟨cut⟩ ``rtol 1e-5``;
- 5 Adam steps: angles ``atol 1e-4`` (Adam divides by the gradient's own
  scale, so an f32 gradient difference of ~1e-6 relative moves an angle by
  far less than one learning-rate step of 0.05);
- whole solves at ``opt_steps=0`` give the equal cut, except where a
  candidate differs, and then the test shows its JAX marginal ties the K-th
  within ``1e-6`` relative (graph automorphisms make exact ties that the
  last ulp breaks either way);
- whole solves at the default 30 steps: the mean cut over three seeds
  within ``BAND`` = 2% (the paper's own accuracy margin) of Σ|w|: the
  angles still agree to ~3e-5 after 30 Adam steps, but exact ties among
  the top-K states (isolated vertices, complement pairs) break either way
  at the last ulp (``repro/core/qaoa.py:172-179``), which moves single
  cuts by a few edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import merge as jmerge
from repro.core import paraqaoa as jpara
from repro.core import partition as jpart
from repro.core import qaoa as jqaoa
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.baselines.brute_force import brute_force_problem
from repro_torch.core import graph as tgraph
from repro_torch.core import merge as tmerge
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import partition as tpart
from repro_torch.core import qaoa as tqaoa

BAND = 0.02
TIE_RTOL = 1e-6
N_QUBITS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_graph(kind, n, p, seed):
    return {"unit": jgraph.Graph.erdos_renyi,
            "uniform": jgraph.Graph.erdos_renyi_weighted,
            "spin": jgraph.Graph.spin_glass}[kind](n, p, seed=seed)


def _torch_graph(kind, n, p, seed):
    return {"unit": tgraph.Graph.erdos_renyi,
            "uniform": tgraph.Graph.erdos_renyi_weighted,
            "spin": tgraph.Graph.spin_glass}[kind](n, p, seed=seed)


def _graphs_equal(j, t):
    assert (j.n, j.n_edges) == (t.n, t.n_edges)
    _eq(j.edges, t.edges)
    _eq(j.weights, t.weights)


def _qubo_pair(n, seed):
    """The same random QUBO in both packages (solve_maxcut's generator)."""
    g = jgraph.Graph.erdos_renyi(n, 0.4, seed=seed)
    e = np.asarray(g.edges)[: g.n_edges]
    rng = np.random.default_rng(seed + 0x9B0)
    q = rng.normal(size=g.n_edges).astype(np.float32)
    h = rng.normal(size=n).astype(np.float32)
    return (jgraph.Problem.qubo(n, e, q, linear=h),
            tgraph.Problem.qubo(n, e, q, linear=h))


def _problems_equal(j, t):
    _graphs_equal(j.graph, t.graph)
    _eq(j.linear, t.linear)
    assert (j.offset, j.kind) == (t.offset, t.kind)


# ---------------------------------------------------------------------------
# numpy stages: equal element for element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unit", "uniform", "spin"])
@pytest.mark.parametrize("seed", [0, 3])
def test_graph_generators_equal(kind, seed):
    _graphs_equal(_jax_graph(kind, 40, 0.2, seed), _torch_graph(kind, 40, 0.2, seed))


def test_from_edges_and_problems_equal():
    edges, w = [(0, 1), (1, 3), (2, 3)], [0.5, -1.0, 2.0]
    _graphs_equal(jgraph.Graph.from_edges(4, edges, w, pad_to=6),
                  tgraph.Graph.from_edges(4, edges, w, pad_to=6))
    _problems_equal(*_qubo_pair(12, seed=1))
    jg, tg = _jax_graph("unit", 20, 0.3, 2), _torch_graph("unit", 20, 0.3, 2)
    _problems_equal(jgraph.Problem.mis(jg), tgraph.Problem.mis(tg))
    _problems_equal(jgraph.Problem.maxcut(jg), tgraph.Problem.maxcut(tg))
    x = np.random.default_rng(0).integers(0, 2, 20).astype(np.int8)
    jp, tp = jgraph.Problem.mis(jg), tgraph.Problem.mis(tg)
    assert float(jgraph.problem_value(jp, jnp.asarray(x))) == float(
        tgraph.problem_value(tp, torch.from_numpy(x)))
    assert jgraph.independent_set_violations(jg, x) == \
        tgraph.independent_set_violations(tg, x)


@pytest.mark.parametrize("n,n_qubits", [(30, 8), (61, 10), (9, 10)])
def test_partition_and_padding_equal(n, n_qubits):
    jg, tg = _jax_graph("uniform", n, 0.3, n), _torch_graph("uniform", n, 0.3, n)
    jp, tp = jpart.partition_for_solver(jg, n_qubits), tpart.partition_for_solver(tg, n_qubits)
    assert jp.ranges == tp.ranges and jp.sizes == tp.sizes
    assert jpart.balanced_ranges(n, 3) == tpart.balanced_ranges(n, 3)
    for a, b in zip(jp.subgraphs, tp.subgraphs):
        _graphs_equal(a, b)
    _eq(jp.inter_edges, tp.inter_edges)
    _eq(jp.inter_weights, tp.inter_weights)
    lin = np.random.default_rng(n).normal(size=n).astype(np.float32)
    for a, b in zip(jpart.split_linear(jp, lin), tpart.split_linear(tp, lin)):
        _eq(a, b)
    rows = jp.m + 2
    for a, b in zip(jqaoa.pad_subgraph_arrays(jp.subgraphs, n_qubits, n_rows=rows),
                    tqaoa.pad_subgraph_arrays(tp.subgraphs, n_qubits, n_rows=rows)):
        _eq(a, b)
    _eq(jqaoa.pad_linear_arrays(jpart.split_linear(jp, lin), n_qubits, n_rows=rows),
        tqaoa.pad_linear_arrays(tpart.split_linear(tp, lin), n_qubits, n_rows=rows))


@pytest.mark.parametrize("with_linear", [False, True])
def test_build_merge_plan_equal(with_linear):
    jg, tg = _jax_graph("uniform", 30, 0.3, 1), _torch_graph("uniform", 30, 0.3, 1)
    jp, tp = jpart.partition_for_solver(jg, N_QUBITS), tpart.partition_for_solver(tg, N_QUBITS)
    cands = np.random.default_rng(2).integers(0, 2**7, (jp.m, 2))
    lin = np.random.default_rng(3).normal(size=30).astype(np.float32) if with_linear else None
    jplan = jmerge.build_merge_plan(jp, cands, 2, linear=lin)
    tplan = tmerge.build_merge_plan(tp, cands, 2, linear=lin)
    for field in jplan._fields:
        _eq(getattr(jplan, field), getattr(tplan, field))
    assert tmerge.exact_beam_width(2, 5) == jmerge.exact_beam_width(2, 5)
    assert tmerge.exact_beam_width(2, 30, cap=1 << 18) == 1 << 18


# ---------------------------------------------------------------------------
# QAOA at fixed angles and a short Adam ascent
# ---------------------------------------------------------------------------

def _cut_batch(n, seed, b=3):
    rng = np.random.default_rng(seed)
    cutv = np.stack([np.asarray(jops.cutvals(
        n, *(jnp.asarray(a) for a in _graph_arrays(n, rng)))) for _ in range(b)])
    return cutv.astype(np.float32)


def _graph_arrays(n, rng):
    g = jgraph.Graph.erdos_renyi(n, 0.5, seed=int(rng.integers(1 << 30)))
    return np.asarray(g.edges), np.asarray(g.weights)


def test_qaoa_statevector_matches_jax_at_fixed_angles():
    n, p = 8, 3
    cutv = _cut_batch(n, seed=4)
    rng = np.random.default_rng(5)
    gammas, betas = convert.angles_from_arrays(rng.uniform(0, 1, (3, p)),
                                               rng.uniform(0, 1, (3, p)))
    with torch.no_grad():
        re, im = tqaoa.qaoa_statevector(torch.from_numpy(cutv), n, gammas, betas)
        exp = tqaoa.qaoa_expectation((gammas, betas), torch.from_numpy(cutv), n)
    run = jax.jit(jqaoa.qaoa_statevector, static_argnums=1)
    jexp = jax.jit(jqaoa.qaoa_expectation, static_argnums=2)
    with jops.using_implementation("xla"):
        for r in range(3):
            args = (jnp.asarray(gammas[r].numpy()), jnp.asarray(betas[r].numpy()))
            jre, jim = run(jnp.asarray(cutv[r]), n, *args)
            np.testing.assert_allclose(re[r].numpy(), np.asarray(jre), atol=2e-5)
            np.testing.assert_allclose(im[r].numpy(), np.asarray(jim), atol=2e-5)
            np.testing.assert_allclose(float(exp[r]),
                                       float(jexp(args, jnp.asarray(cutv[r]), n)),
                                       rtol=1e-5)


def test_five_adam_steps_match_jax():
    n = 7
    cutv = _cut_batch(n, seed=6)
    jcfg = jqaoa.QAOAConfig(n_qubits=n, opt_steps=5)
    tcfg = tqaoa.QAOAConfig(n_qubits=n, opt_steps=5)
    g, b = tqaoa.optimize_params(torch.from_numpy(cutv), n, tcfg)
    opt = jax.jit(jqaoa.optimize_params, static_argnums=(1, 2))
    with jops.using_implementation("xla"):
        for r in range(3):
            jg, jb = opt(jnp.asarray(cutv[r]), n, jcfg)
            np.testing.assert_allclose(g[r].numpy(), np.asarray(jg), atol=1e-4)
            np.testing.assert_allclose(b[r].numpy(), np.asarray(jb), atol=1e-4)
    # the ascent moved the angles off the ramp
    g0, _ = tqaoa.linear_ramp_init(3, 0.75)
    assert float((g - g0).abs().max()) > 0.05


def test_topk_marginal_folds_pad_bits_with_lower_index_first_on_ties():
    n = 4
    probs = np.zeros((2, 2**n), np.float32)
    probs[0, [1, 1 + 8, 6]] = [0.25, 0.25, 0.5]  # row 0: 3 real qubits
    probs[1, [2, 5]] = [0.5, 0.5]  # row 1: 4 real qubits, a tie
    re = torch.from_numpy(np.sqrt(probs))
    idx, val = tqaoa.topk_marginal(re, torch.zeros_like(re), n,
                                   torch.tensor([7, 15]), 2)
    _eq(idx, [[1, 6], [2, 5]])
    np.testing.assert_allclose(val.numpy(), [[0.5, 0.5], [0.5, 0.5]], rtol=1e-6)


# ---------------------------------------------------------------------------
# the merge on the JAX solver's candidates, and whole solves
# ---------------------------------------------------------------------------

FAMILIES = ["unit", "uniform", "spin", "qubo"]
_CACHE = {}


def _family(kind):
    """(JAX instance, port instance, integer weights?) for a family."""
    if kind == "qubo":
        j, t = _qubo_pair(24, seed=11)
        return j, t, False
    j, t = _jax_graph(kind, 30, 0.3, 7), _torch_graph(kind, 30, 0.3, 7)
    return j, t, kind != "uniform"


def _jax_run(kind, steps):
    """JAX solve, its candidates and their marginals, computed once."""
    key = (kind, steps)
    if key not in _CACHE:
        j, _, _ = _family(kind)
        cfg = jpara.ParaQAOAConfig(n_qubits=N_QUBITS, opt_steps=steps)
        out = jpara.solve(j, cfg)
        prob = jgraph.as_problem(j)
        part = out.partition
        e, w, m = jqaoa.pad_subgraph_arrays(part.subgraphs, N_QUBITS)
        if prob.has_linear:
            lins = jqaoa.pad_linear_arrays(jpart.split_linear(part, prob.linear), N_QUBITS)
            res = jqaoa.solve_subgraph_batch_program(cfg.qaoa_config(), has_linear=True)(
                e, w, m, lins)
        else:
            lins = None
            res = jqaoa.solve_subgraph_batch_program(cfg.qaoa_config())(e, w, m)
        _CACHE[key] = (out, np.asarray(res.bitstrings), np.asarray(res.probs),
                       (np.asarray(e), np.asarray(w), np.asarray(m), lins))
    return _CACHE[key]


@pytest.mark.parametrize("kind", FAMILIES)
def test_merge_on_jax_candidates_matches_jax(kind):
    """The port's merge of the JAX solver's candidates against the JAX
    solve's own merge of them (its reported assignment and value)."""
    _, t, exact = _family(kind)
    jout, cands, _, _ = _jax_run(kind, 0)
    tprob = tgraph.as_problem(t)
    lin = tprob.linear.numpy() if tprob.has_linear else None
    tcfg = tpara.ParaQAOAConfig(n_qubits=N_QUBITS)
    tpart_ = tpart.partition_for_solver(tprob.graph, N_QUBITS)
    ta, ts, tbw = tpara.merge_candidates(tpart_, cands, tcfg, linear=lin)
    assert tbw == jout.report.extra["beam"]
    internal = jout.cut_value - tprob.offset
    if exact:
        _eq(ta, jout.assignment)
        assert ts == internal
    else:
        np.testing.assert_allclose(ts, internal, rtol=1e-5)


def _jax_marginal(kind, row, lin_rows):
    """Full marginal over row ``row``'s real qubits at the ramp angles."""
    _, _, _, (e, w, m, _) = _jax_run(kind, 0)
    lin = None if lin_rows is None else jnp.asarray(np.asarray(lin_rows)[row])
    qcfg = jqaoa.QAOAConfig(n_qubits=N_QUBITS)
    g, b = jqaoa.linear_ramp_init(qcfg.p_layers, qcfg.ramp_delta)
    with jops.using_implementation("xla"):
        cutv = jops.cutvals(N_QUBITS, jnp.asarray(e[row]), jnp.asarray(w[row]), lin)
        re, im = jqaoa.qaoa_statevector(cutv, N_QUBITS, g, b)
    probs = np.asarray(re) ** 2 + np.asarray(im) ** 2
    marg = np.zeros_like(probs)
    np.add.at(marg, np.arange(2**N_QUBITS) & int(m[row]), probs)
    return marg


@pytest.mark.parametrize("kind", FAMILIES)
def test_solve_matches_jax_at_zero_steps(kind):
    j, t, exact = _family(kind)
    jout, jcands, jprobs, (_, _, masks, lins) = _jax_run(kind, 0)
    tout = tpara.solve(t, tpara.ParaQAOAConfig(n_qubits=N_QUBITS, opt_steps=0),
                       device="cpu")
    complement = not tgraph.as_problem(t).has_linear
    differing = []
    for row in range(jcands.shape[0]):
        def canon(c):
            return {min(int(x), int(x) ^ int(masks[row])) if complement else int(x)
                    for x in c}
        extra = canon(tout.candidates[row]) - canon(jcands[row])
        if extra:
            marg = _jax_marginal(kind, row, lins)
            kth = jprobs[row, -1]
            for c in tout.candidates[row]:
                if int(c) not in set(map(int, jcands[row])):
                    assert abs(marg[int(c)] - kth) <= TIE_RTOL * kth, (
                        f"row {row}: port candidate {c} is no tie for JAX's K-th")
            differing.append(row)
    if not differing:
        if exact:
            assert tout.cut_value == jout.cut_value
        else:
            np.testing.assert_allclose(tout.cut_value, jout.cut_value, rtol=1e-5)


@pytest.mark.parametrize("kind", ["unit", "uniform", "spin"])
def test_solve_within_band_of_jax_at_default_steps(kind):
    """Mean cut over three instances within BAND of Σ|w| of the JAX mean.

    Single instances may differ by a tie broken the other way (measured:
    up to 4 edges of ~130 on G(30, 0.3)); the mean over seeds is the
    quality the paper's 2% margin speaks of. The band is relative to Σ|w|,
    the largest possible cut, because spin-glass cuts sit near zero. The
    JAX cut is the merge of the JAX solver's candidates (the merge itself
    is held equal above), so one compiled JAX solve program serves all
    three instances: their batches are padded to one shape.
    """
    seeds = (0, 1, 2)
    tcfg = tpara.ParaQAOAConfig(n_qubits=N_QUBITS)
    program = jqaoa.solve_subgraph_batch_program(
        jpara.ParaQAOAConfig(n_qubits=N_QUBITS).qaoa_config())
    e_pad = N_QUBITS * (N_QUBITS - 1) // 2  # every subgraph's edges fit
    jcuts, tcuts, scale = [], [], []
    for s in seeds:
        g = _torch_graph(kind, 30, 0.3, s)
        part = tpart.partition_for_solver(g, N_QUBITS)
        jcands = np.asarray(program(*jqaoa.pad_subgraph_arrays(
            _jax_part(kind, s).subgraphs, N_QUBITS, e_pad=e_pad)).bitstrings)
        jcuts.append(tpara.merge_candidates(part, jcands, tcfg)[1])
        tcuts.append(tpara.solve(g, tcfg, device="cpu").cut_value)
        scale.append(float(g.weights.abs().sum()))
    assert abs(np.mean(tcuts) - np.mean(jcuts)) <= BAND * np.mean(scale), (
        tcuts, jcuts)


def _jax_part(kind, seed):
    return jpart.partition_for_solver(_jax_graph(kind, 30, 0.3, seed), N_QUBITS)


def _scale(prob):
    """Σ|w| + Σ|h|: the objective's range, what a relative band is of."""
    return float(np.abs(np.asarray(prob.graph.weights)).sum()
                 + np.abs(np.asarray(prob.linear)).sum())


@pytest.mark.parametrize("kind", ["qubo", "mis"])
def test_small_qubo_and_mis_against_brute_force(kind):
    if kind == "qubo":
        jprob, tprob = _qubo_pair(12, seed=21)
    else:
        jprob = jgraph.Problem.mis(jgraph.Graph.erdos_renyi(12, 0.3, seed=22))
        tprob = tgraph.Problem.mis(tgraph.Graph.erdos_renyi(12, 0.3, seed=22))
    _, opt, _ = brute_force_problem(tprob, device="cpu")
    cfg = dict(n_qubits=N_QUBITS)
    tval = tpara.solve(tprob, tpara.ParaQAOAConfig(**cfg), device="cpu").cut_value
    jval = jpara.solve(jprob, jpara.ParaQAOAConfig(**cfg)).cut_value
    assert tval <= opt + 1e-4 * _scale(tprob), (tval, opt)
    assert abs(tval - jval) <= BAND * _scale(tprob), (tval, jval)


def test_refine_raises_until_ported():
    """The port's refined solve against the JAX one (``refine_steps`` 25).

    At ``opt_steps = 0`` the candidates are equal up to float64 ties of the
    marginals, and where every row is equal, so are the refined assignment
    and value (integer weights: the refinement's gains are exact). At the
    default 30 steps, the mean refined cut over three instances lies within
    BAND of Σ|w| of the JAX mean, as the unrefined solve's does.
    """
    from test_torch_baselines import marginal64, tie64

    j, t, _ = _family("unit")
    _, jcands, _, _ = _jax_run("unit", 0)
    cfg = dict(n_qubits=N_QUBITS, opt_steps=0, refine_steps=25)
    jout = jpara.solve(j, jpara.ParaQAOAConfig(**cfg))
    tout = tpara.solve(t, tpara.ParaQAOAConfig(**cfg), device="cpu")
    assert tout.timings.keys() == jout.timings.keys()  # the JAX stages' seconds
    part = tout.partition
    differ = [row for row in range(part.m)
              if set(map(int, tout.candidates[row])) != set(map(int, jcands[row]))]
    for row in differ:
        marg = marginal64(part.subgraphs[row], N_QUBITS)
        kth = min(jcands[row], key=lambda c: marg[int(c)])
        for c in set(map(int, tout.candidates[row])) - set(map(int, jcands[row])):
            assert tie64(marg, c, int(kth)), f"row {row}: {c} is no tie for {kth}"
    if not differ:
        _eq(tout.assignment, jout.assignment)
        assert tout.cut_value == jout.cut_value

    jcuts, tcuts, scale = [], [], []
    for s in (0, 1, 2):
        g = _torch_graph("unit", 30, 0.3, s)
        jcuts.append(jpara.solve(_jax_graph("unit", 30, 0.3, s), jpara.ParaQAOAConfig(
            n_qubits=N_QUBITS, refine_steps=25)).cut_value)
        tcuts.append(tpara.solve(g, tpara.ParaQAOAConfig(
            n_qubits=N_QUBITS, refine_steps=25), device="cpu").cut_value)
        scale.append(float(g.weights.abs().sum()))
    assert abs(np.mean(tcuts) - np.mean(jcuts)) <= BAND * np.mean(scale), (
        tcuts, jcuts)


def test_convert_builds_port_problems_from_reference_arrays():
    j, _ = _qubo_pair(10, seed=5)
    t = convert.problem_from_arrays(j.n, np.asarray(j.graph.edges),
                                    np.asarray(j.graph.weights), j.graph.n_edges,
                                    linear=np.asarray(j.linear), offset=j.offset,
                                    kind=j.kind)
    _problems_equal(j, t)
    g = _jax_graph("spin", 15, 0.3, 1)
    tg = convert.problem_from_arrays(g.n, np.asarray(g.edges), np.asarray(g.weights),
                                     g.n_edges)
    assert isinstance(tg, tgraph.Graph)
    _graphs_equal(g, tg)


def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch import solve_maxcut

    out = solve_maxcut.run(["--n", "24", "--qubits", "8", "--opt-steps", "2",
                            "--problem", "qubo", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[maxcut] value = " in text and "solve_s" in text
    assert np.isfinite(out.cut_value)
