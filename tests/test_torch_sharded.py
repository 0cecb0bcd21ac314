"""The port's sharded statevector (`model` axis) against the JAX package.

Inputs come from numpy seeds and go to both packages as the same arrays;
the port runs on CPU tensors, where every kernel wrapper takes its plain
version. What each comparison holds, and why:

- index maps and cut tables: integer arithmetic, or f32 sums in edge
  order of 0/1 times the weights: equal exactly for unit weights; with
  linear rows within ``1e-6`` of the table's scale (XLA's scan may
  contract the multiply-add);
- states at fixed angles, reassembled through the index maps, against the
  JAX flat statevector: ``atol 1e-6`` (amplitudes ~3e-2; the per-shard
  layer and the 2^h-wide global mix round in another order than the flat
  groups); ⟨cut⟩ ``rtol 1e-6``; top-K probabilities ``atol 1e-7``, all
  tighter than ``repro/core/_dist_checks.py:52-89`` (1e-4, 1e-5, 1e-6);
- gradients within ``2e-3`` of the gradient scale (``_dist_checks.py:169``);
- 30 sharded Adam steps within ``1e-4`` of the JAX flat optimizer
  (``_dist_checks.py:179-187``);
- whole solves: the sharded solve equals the flat solve at the lifted
  budget on the same partition, up to candidates whose marginals tie the
  K-th within ``1e-6`` relative (as tests/test_torch_core.py);
- two gloo ranks (`ProcessGroupAxis`) against `LocalAxis`: the same
  per-shard arithmetic, so within ``1e-6``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import qaoa as jqaoa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import mesh as jmesh
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import qaoa as tqaoa
from repro_torch.core.axis import LocalAxis
from repro_torch.core.graph import Graph
from repro_torch.core.partition import partition_for_solver
from repro_torch.kernels import mixer, ops
from repro_torch.launch import mesh as tmesh

REPO = Path(__file__).resolve().parent.parent
STATE_ATOL, EXP_RTOL, PROB_ATOL = 1e-6, 1e-6, 1e-7
GRAD_SCALE_TOL, ANGLE_ATOL, TIE_RTOL = 2e-3, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graph_batch(n, seed, b=2, p=0.5, linear=False):
    """``b`` random graphs on n vertices as (E_pad, 2)/(E_pad,) numpy rows."""
    rng = np.random.default_rng(seed)
    gs = [Graph.erdos_renyi(n, p, seed=int(rng.integers(1 << 30))) for _ in range(b)]
    e_pad = max(g.n_edges for g in gs)
    edges = np.zeros((b, e_pad, 2), np.int32)
    weights = np.zeros((b, e_pad), np.float32)
    for r, g in enumerate(gs):
        edges[r, :g.n_edges] = g.edges.numpy()[:g.n_edges]
        weights[r, :g.n_edges] = g.weights.numpy()[:g.n_edges]
    lin = rng.standard_normal((b, n)).astype(np.float32) if linear else None
    return edges, weights, lin


def _angles(p, seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 0.9, (b, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, (b, p)).astype(np.float32))


def _assemble(layout, planes, in_b):
    """(B·D, L) shard rows → (B, 2^n) global states via the index maps."""
    d = layout.axis.size
    out = np.zeros((planes.shape[0] // d, 2**layout.n), np.float32)
    for s in range(d):
        idx = tengine.layout_index_maps(layout, s)[int(in_b)]
        out[:, idx] = planes[s::d]
    return out


def _jax_flat(edges, weights, gammas, betas, n, lin=None):
    """The JAX flat statevector, ⟨cut⟩ and probabilities, one row each."""
    with jops.using_implementation("xla"):
        outs = []
        for r in range(edges.shape[0]):
            cutv = jref.cutvals(n, jnp.asarray(edges[r]), jnp.asarray(weights[r]),
                                None if lin is None else jnp.asarray(lin[r]))
            re, im = jax.jit(jqaoa.qaoa_statevector, static_argnums=1)(
                cutv, n, jnp.asarray(gammas[r]), jnp.asarray(betas[r]))
            exp = float(jref.expectation(re, im, cutv))
            outs.append((np.asarray(re), np.asarray(im), exp))
    return outs


# ---------------------------------------------------------------------------
# (a) index maps, (b) cut tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(8, 2), (10, 4), (4, 4)])
def test_layout_index_maps_equal_jax(n, d):
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d))
    jlayout = jengine.ShardedLayout(n=n, axis="model", axis_size=d)
    idx_a, idx_b = tengine.index_tables(layout, "cpu")
    for s in range(d):
        want = jengine.layout_index_maps(jlayout, s)
        got = tengine.layout_index_maps(layout, s)
        for g, t, w in zip(got, (idx_a[s], idx_b[s]), want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(t.numpy(), w)
    # layout B is a permutation of the whole index space
    assert sorted(np.concatenate(
        [tengine.layout_index_maps(layout, s)[1] for s in range(d)]).tolist()) \
        == list(range(2**n))


@pytest.mark.parametrize("linear", [False, True])
def test_cutvals_at_plain_matches_jax_ref_on_both_views(linear):
    n, d = 10, 4
    edges, weights, lin = _graph_batch(n, seed=1, linear=linear)
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d))
    tlin = None if lin is None else torch.from_numpy(lin)
    cut = tengine.cut_table(layout, torch.from_numpy(edges),
                            torch.from_numpy(weights), tlin)
    for view, in_b in (("A", False), ("B", True)):
        got = cut.at(in_b).numpy()
        for b in range(edges.shape[0]):
            for s in range(d):
                idx = jnp.asarray(cut.idx(in_b)[s].numpy())
                want = np.asarray(jref.cutvals_at(
                    idx, jnp.asarray(edges[b]), jnp.asarray(weights[b]),
                    None if lin is None else jnp.asarray(lin[b])))
                if linear:
                    np.testing.assert_allclose(got[b * d + s], want, rtol=0,
                                               atol=1e-6 * np.abs(want).max(),
                                               err_msg=view)
                else:
                    np.testing.assert_array_equal(got[b * d + s], want, err_msg=view)


def test_faithful_schedule_builds_only_layout_a():
    edges, weights, _ = _graph_batch(8, seed=2)
    layout = tengine.ShardedLayout(n=8, axis=LocalAxis(2), schedule="faithful")
    cut = tengine.cut_table(layout, torch.from_numpy(edges), torch.from_numpy(weights))
    assert cut.cutv_b is None and cut.idx_b is None
    assert cut.cutv_a.shape == (4, 2**7)


# ---------------------------------------------------------------------------
# (c) states at fixed angles, (d) gradients, (e) the sharded ascent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("schedule", ["faithful", "alternating"])
def test_sharded_evolve_matches_jax_flat(d, schedule):
    n, p, k = 10, 2, 4
    edges, weights, _ = _graph_batch(n, seed=3)
    gammas, betas = _angles(p, seed=4)
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d), schedule=schedule)
    cut = tengine.cut_table(layout, torch.from_numpy(edges), torch.from_numpy(weights))
    with torch.no_grad():
        re, im, in_b = tengine.evolve(layout, cut, torch.from_numpy(gammas),
                                      torch.from_numpy(betas))
        exp = tengine.expectation(layout, re, im, cut, in_b).numpy()
        bits, probs = tengine.top_candidates(layout, re, im, cut, in_b, k)
    assert in_b == (schedule == "alternating" and p % 2 == 1)
    g_re, g_im = _assemble(layout, re.numpy(), in_b), _assemble(layout, im.numpy(), in_b)
    for r, (jre, jim, jexp) in enumerate(_jax_flat(edges, weights, gammas, betas, n)):
        np.testing.assert_allclose(g_re[r], jre, atol=STATE_ATOL)
        np.testing.assert_allclose(g_im[r], jim, atol=STATE_ATOL)
        np.testing.assert_allclose(exp[r], jexp, rtol=EXP_RTOL)
        jprobs = jre**2 + jim**2
        want_v = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), k)[0])
        np.testing.assert_allclose(np.sort(probs[r].numpy()), np.sort(want_v),
                                   atol=PROB_ATOL)
        # each candidate's probability is the flat one at its global index
        np.testing.assert_allclose(jprobs[bits[r].numpy()], probs[r].numpy(),
                                   atol=PROB_ATOL)


def test_sharded_evolve_odd_depth_ends_in_layout_b():
    n, d = 8, 2
    edges, weights, _ = _graph_batch(n, seed=5, b=1)
    gammas, betas = _angles(3, seed=6, b=1)
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d))
    cut = tengine.cut_table(layout, torch.from_numpy(edges), torch.from_numpy(weights))
    with torch.no_grad():
        re, im, in_b = tengine.evolve(layout, cut, torch.from_numpy(gammas),
                                      torch.from_numpy(betas))
    assert in_b
    (jre, jim, _), = _jax_flat(edges, weights, gammas, betas, n)
    np.testing.assert_allclose(_assemble(layout, re.numpy(), True)[0], jre, atol=STATE_ATOL)
    np.testing.assert_allclose(_assemble(layout, im.numpy(), True)[0], jim, atol=STATE_ATOL)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_gradient_matches_jax_grad_of_flat(d):
    n = 10
    edges, weights, _ = _graph_batch(n, seed=7)
    g0, b0 = tqaoa.linear_ramp_init(3, 0.75)
    gammas, betas = g0.expand(2, -1).clone(), b0.expand(2, -1).clone()
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d))
    cut = tengine.cut_table(layout, torch.from_numpy(edges), torch.from_numpy(weights))
    leaves = [gammas.requires_grad_(True), betas.requires_grad_(True)]
    re, im, in_b = tengine.evolve(layout, cut, *leaves)
    got = torch.autograd.grad(tengine.expectation(layout, re, im, cut, in_b).sum(), leaves)
    grad = jax.jit(jax.grad(jqaoa.qaoa_expectation), static_argnums=2)
    with jops.using_implementation("xla"):
        for r in range(2):
            cutv = jref.cutvals(n, jnp.asarray(edges[r]), jnp.asarray(weights[r]))
            want = grad((jnp.asarray(g0.numpy()), jnp.asarray(b0.numpy())), cutv, n)
            scale = max(float(jnp.max(jnp.abs(w))) for w in want)
            for gt, w in zip(got, want):
                np.testing.assert_allclose(gt[r].numpy(), np.asarray(w), rtol=0,
                                           atol=GRAD_SCALE_TOL * max(scale, 1.0))


def test_sharded_ascent_lands_on_jax_flat_optimum():
    n = 10
    g = Graph.erdos_renyi(n, 0.5, seed=3)
    g0, b0 = tqaoa.linear_ramp_init(3, 0.75)
    axis = LocalAxis(4)
    r_ramp = tdist.sharded_qaoa(g.edges, g.weights, n, g0, b0, axis)
    r_opt = tdist.sharded_qaoa(g.edges, g.weights, n, g0, b0, axis, opt_steps=30)
    assert float(r_opt.expectation) >= float(r_ramp.expectation)
    cutv = jref.cutvals(n, jnp.asarray(g.edges.numpy()), jnp.asarray(g.weights.numpy()))
    with jops.using_implementation("xla"):
        want = jax.jit(jqaoa.optimize_params, static_argnums=(1, 2))(
            cutv, n, jqaoa.QAOAConfig(n_qubits=n, p_layers=3, opt_steps=30))
    for gt, w in zip((r_opt.gammas, r_opt.betas), want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=ANGLE_ATOL)


def test_batch_in_several_launches_equals_one_launch_with_linear_terms(monkeypatch):
    n, d = 8, 2
    edges, weights, lin = _graph_batch(n, seed=8, b=3, linear=True)
    gammas, betas = _angles(2, seed=9, b=3)
    args = (torch.from_numpy(edges), torch.from_numpy(weights), n,
            torch.from_numpy(gammas), torch.from_numpy(betas), LocalAxis(d))
    kw = dict(top_k=3, opt_steps=2, linears=torch.from_numpy(lin))
    one = tdist.sharded_qaoa_batch(*args, **kw)
    monkeypatch.setattr(tdist, "subgraphs_per_launch", lambda *a: 2)
    split = tdist.sharded_qaoa_batch(*args, **kw)
    for a, b in zip(one, split):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launch_planner_fits_the_card(monkeypatch):
    assert tdist.launch_slices(15, 12) == [slice(0, 8), slice(8, 15)]
    assert tdist.launch_slices(3, 5) == [slice(0, 3)]
    assert tdist.subgraphs_per_launch(26, 3, 0, LocalAxis(4), "cpu") >= 1 << 20
    # an 80 GB card: 15 subgraphs of 26 qubits in one launch without
    # autograd (48 B/amplitude), 4 with it (160 B at p = 3)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: type("P", (), {"total_memory": 85_000_000_000}))
    assert tdist.subgraphs_per_launch(26, 3, 0, LocalAxis(4), "cuda") == 15
    assert tdist.subgraphs_per_launch(26, 3, 30, LocalAxis(4), "cuda") == 4


def test_stable_topk_in_row_chunks_equals_one_sort(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(10).integers(0, 4, (5, 64)).astype(np.float32))
    want = tengine.stable_topk(x, 6)
    monkeypatch.setattr(tengine, "SORT_CHUNK", 100)
    got = tengine.stable_topk(x, 6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (f) the solve, (g) chunk == 1
# ---------------------------------------------------------------------------

def _flat_marginal(part, row, n_qubits, cfg):
    """The flat solve's marginal of subgraph ``row`` at the ramp angles."""
    e, w, m = tqaoa.pad_subgraph_arrays([part.subgraphs[row]], n_qubits)
    cutv = ops.cutvals(n_qubits, e, w)
    g0, b0 = tqaoa.linear_ramp_init(cfg.p_layers, cfg.ramp_delta)
    with torch.no_grad():
        re, im = tqaoa.qaoa_statevector(cutv, n_qubits, g0[None], b0[None])
    probs = (re * re + im * im)[0].numpy()
    marg = np.zeros_like(probs)
    np.add.at(marg, np.arange(2**n_qubits) & int(m[0]), probs)
    return marg


def test_solve_distributed_equals_lifted_flat_solve():
    """``_dist_checks.py:341-349``: at opt_steps=0 the model-sharded solve
    runs the same ramp angles as the flat solve at the lifted budget."""
    g = Graph.erdos_renyi(48, 0.3, seed=7)
    cfg = tpara.ParaQAOAConfig(n_qubits=8, top_k=2, p_layers=2, opt_steps=0)
    part = partition_for_solver(g, 10)
    want = tpara.solve(g, tpara.ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=2,
                                               opt_steps=0), partition=part,
                       device="cpu")
    got = tdist.solve_distributed(g, cfg, "model=4", device="cpu")
    assert got.partition.ranges == part.ranges
    assert got.report.extra["sharded_subproblems"] == 5  # sizes 8, 9, 9, 9, 9, 9
    if got.cut_value != want.cut_value:
        for row in range(part.m):
            a = {int(x) for x in got.candidates[row]}
            b = {int(x) for x in want.candidates[row]}
            if a != b:
                marg = _flat_marginal(part, row, 10, cfg)
                kth = min(marg[list(b)])
                for c in a - b:
                    assert abs(marg[c] - kth) <= TIE_RTOL * kth, (row, c)


def test_chunk_one_goes_through_the_trailing_mixer(monkeypatch):
    n, d = 4, 4  # L = 4, chunk = 1: the global mix is the trailing group
    calls = []
    trailing = mixer.mixer_group_trailing

    def spy(*a, **k):
        calls.append(a[0].shape)
        return trailing(*a, **k)

    monkeypatch.setattr(mixer, "mixer_group_trailing", spy)
    edges, weights, _ = _graph_batch(n, seed=11, p=0.6)
    gammas, betas = _angles(3, seed=12)
    layout = tengine.ShardedLayout(n=n, axis=LocalAxis(d))
    assert layout.chunk == 1
    cut = tengine.cut_table(layout, torch.from_numpy(edges), torch.from_numpy(weights))
    with torch.no_grad():
        re, im, in_b = tengine.evolve(layout, cut, torch.from_numpy(gammas),
                                      torch.from_numpy(betas))
        flat = tqaoa.qaoa_statevector(ops.cutvals(n, torch.from_numpy(edges),
                                                        torch.from_numpy(weights)),
                                      n, torch.from_numpy(gammas), torch.from_numpy(betas))
    # the global mix of each layer: 2 qubits at local bit 0 of 8 rows
    assert calls == [(2 * d, 1, 4)] * 3
    for got, want in zip((re, im), flat):
        np.testing.assert_allclose(_assemble(layout, got.numpy(), in_b), want.numpy(),
                                   atol=STATE_ATOL)


# ---------------------------------------------------------------------------
# (h) two gloo ranks, (i) the CLI, and the entry points' rules
# ---------------------------------------------------------------------------

_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import engine
from repro_torch.core.axis import ProcessGroupAxis
from repro_torch.core.distributed import sharded_qaoa_batch, solve_distributed
from repro_torch.core.graph import Graph
from repro_torch.core.paraqaoa import ParaQAOAConfig

axis = ProcessGroupAxis.from_env("cpu")
data = np.load(sys.argv[1])
e, w = torch.from_numpy(data["edges"]), torch.from_numpy(data["weights"])
g, b = torch.from_numpy(data["gammas"]), torch.from_numpy(data["betas"])
out = {}
for sched in ("faithful", "alternating"):
    layout = engine.ShardedLayout(n=8, axis=axis, schedule=sched)
    cut = engine.cut_table(layout, e, w)
    with torch.no_grad():
        re, im, in_b = engine.evolve(layout, cut, g, b)
        out[sched + "_re"], out[sched + "_im"] = re.numpy(), im.numpy()
        out[sched + "_exp"] = engine.expectation(layout, re, im, cut, in_b).numpy()
        bits, probs = engine.top_candidates(layout, re, im, cut, in_b, 4)
        out[sched + "_bits"], out[sched + "_probs"] = bits.numpy(), probs.numpy()
res = sharded_qaoa_batch(e, w, 8, g, b, axis, opt_steps=2)
out["opt_gammas"], out["opt_betas"] = res.gammas.numpy(), res.betas.numpy()
sol = solve_distributed(Graph.erdos_renyi(30, 0.3, seed=4),
                        ParaQAOAConfig(n_qubits=6, p_layers=2, opt_steps=0),
                        "model=2", device="cpu")
out["cut"] = np.float64(sol.cut_value)
out["axis"] = np.array(sol.report.extra["axis"])
np.savez(os.path.join(os.path.dirname(sys.argv[1]), f"rank{axis.offset}.npz"), **out)
torch.distributed.destroy_process_group()
"""


def test_process_group_axis_over_gloo_matches_local_axis(tmp_path):
    n, d = 8, 2
    edges, weights, _ = _graph_batch(n, seed=13)
    gammas, betas = _angles(3, seed=14)
    np.savez(tmp_path / "inputs.npz", edges=edges, weights=weights,
             gammas=gammas, betas=betas)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE=str(d),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT,
                               str(tmp_path / "inputs.npz")],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(d)]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(d)]

    axis = LocalAxis(d)
    e, w = torch.from_numpy(edges), torch.from_numpy(weights)
    g, b = torch.from_numpy(gammas), torch.from_numpy(betas)
    for sched in ("faithful", "alternating"):
        layout = tengine.ShardedLayout(n=n, axis=axis, schedule=sched)
        cut = tengine.cut_table(layout, e, w)
        with torch.no_grad():
            re, im, in_b = tengine.evolve(layout, cut, g, b)
            exp = tengine.expectation(layout, re, im, cut, in_b).numpy()
            bits, probs = tengine.top_candidates(layout, re, im, cut, in_b, 4)
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[sched + "_re"], re.numpy()[r::d], atol=1e-6)
            np.testing.assert_allclose(got[sched + "_im"], im.numpy()[r::d], atol=1e-6)
            np.testing.assert_allclose(got[sched + "_exp"], exp, atol=1e-6)
            np.testing.assert_array_equal(got[sched + "_bits"], bits.numpy())
            np.testing.assert_allclose(got[sched + "_probs"], probs.numpy(), atol=1e-7)
    res = tdist.sharded_qaoa_batch(e, w, n, g, b, axis, opt_steps=2)
    sol = tdist.solve_distributed(Graph.erdos_renyi(30, 0.3, seed=4),
                                  tpara.ParaQAOAConfig(n_qubits=6, p_layers=2,
                                                       opt_steps=0),
                                  "model=2", device="cpu")
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["opt_gammas"], res.gammas.numpy(), atol=1e-6)
        np.testing.assert_allclose(got["opt_betas"], res.betas.numpy(), atol=1e-6)
        assert float(got["cut"]) == sol.cut_value
        assert str(got["axis"]) == f"ProcessGroupAxis(size=2, rank={r})"


def test_cli_with_data_mesh_and_striped_merge_runs_on_cpu(capsys):
    from repro_torch.launch import solve_maxcut

    argv = ["--n", "40", "--qubits", "7", "--opt-steps", "1", "--device", "cpu"]
    out = solve_maxcut.run([*argv, "--mesh", "data=2", "--merge", "striped"])
    text = capsys.readouterr().out
    assert "2 merge shards (striped)" in text and "LocalAxis(2)" in text
    assert out.report.extra["merge_shards"] == 2
    assert out.cut_value == solve_maxcut.run(argv).cut_value  # exhaustive at K^M


def test_cli_with_model_mesh_runs_on_cpu(capsys):
    from repro_torch.launch import solve_maxcut

    out = solve_maxcut.run(["--n", "40", "--qubits", "7", "--mesh", "model=4",
                            "--opt-steps", "1", "--sharded-opt-steps", "1",
                            "--schedule", "faithful", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "LocalAxis(4)" in text and "model-sharded subproblems" in text
    assert out.report.extra["sharded_subproblems"] > 0
    assert np.isfinite(out.cut_value)


@pytest.mark.parametrize("spec", ["model=4", "data=2,model=4", " model = 8 ,pod=2",
                                  "model=3", "model=0", "gpu=2", "model", "",
                                  "model=2,model=4", "data=x"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jmesh.parse_mesh_spec(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_spec(spec)
        assert str(got.value) == str(err)
    else:
        assert tmesh.parse_mesh_spec(spec) == want
        assert tmesh.mesh_spec_size(want) == jmesh.mesh_spec_size(want)


@pytest.mark.parametrize("spec", ["data=2", "data=2,model=4", {"pod": 1, "model": 2}])
def test_data_axis_raises_not_implemented(spec):
    """The mesh specs with a batch axis run: each gives the cut, assignment
    and candidates of the same solve without its batch axes (the
    single-device solve, or the model-only mesh), and `merge_shards` is
    the data axis's size where the exhaustive merge stripes."""
    g = Graph.erdos_renyi(12, 0.3, seed=0)
    cfg = tpara.ParaQAOAConfig(n_qubits=6, opt_steps=2)
    got = tdist.solve_distributed(g, cfg, spec, device="cpu")
    model = tmesh.parse_mesh_spec(spec) if isinstance(spec, str) else spec
    model = model.get("model")
    want = (tdist.solve_distributed(g, cfg, {"model": model}, device="cpu") if model
            else tpara.solve(g, cfg, device="cpu"))
    assert got.cut_value == want.cut_value
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.candidates, want.candidates)
    data = 2 if "data" in str(spec) else 1
    assert got.report.extra["merge_shards"] == (data if got.partition.m > 1 else 1)


def test_solve_distributed_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Graph.erdos_renyi(12, 0.3, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        tdist.solve_distributed(g, tpara.ParaQAOAConfig(n_qubits=6), "model=2")


def test_no_mesh_is_the_single_device_solve():
    g = Graph.erdos_renyi(20, 0.3, seed=1)
    cfg = tpara.ParaQAOAConfig(n_qubits=6, opt_steps=1)
    a = tdist.solve_distributed(g, cfg, None, device="cpu")
    b = tpara.solve(g, cfg, device="cpu")
    assert a.cut_value == b.cut_value and a.report.method == "paraqaoa"
