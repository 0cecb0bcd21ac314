"""The port's `data` mesh axis (solver pool, striped merge, the solve's
merge policy) against the JAX package and the port's own single-device
solve, on the CPU.

What each comparison holds, and why:

- each stripe of the striped merge against the JAX ``merge_scan`` run
  with a plain int ``shard_id`` (no ``shard_map``): integer weights, so
  every score is an exact f32 sum and the best value and assignment are
  equal; the global winner against a numpy reduction of those stripes
  (the max, the lowest shard among equals), and at `striped_beam_width`
  the exhaustive value;
- `striped_beam_width` is integer arithmetic: equal to the JAX one;
- the solver pool pads its rows and solves them in one batch: its result
  is bitwise the single-device batch's, since no op mixes rows;
- the ports of the JAX distributed checks print only true values;
- ranks over gloo run the same per-row arithmetic as one process: equal
  cut, assignment and candidates.

The JAX checks of the data axis fail on this tree (``x[:m]`` on a
data-sharded pool result), so the whole solves are held against the
port's single-device `solve`. Ties are never widened: the merges here
score integer weights exactly.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import merge as jmerge
from repro.core import partition as jpart
from repro_torch.core import _dist_checks
from repro_torch.core import distributed as tdist
from repro_torch.core import merge as tmerge
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import qaoa as tqaoa
from repro_torch.core.axis import LocalAxis, Mesh
from repro_torch.core.graph import Graph
from repro_torch.core.partition import (connectivity_preserving_partition,
                                        partition_for_solver, split_linear)

REPO = Path(__file__).resolve().parent.parent
D_MERGE, K_MERGE = 8, 2  # the JAX check_merge_sharded instance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _merge_instance():
    """G(32, 0.5, seed 2) in 4 ranges, K = 2 random candidates a subgraph
    (``repro/core/_dist_checks.py:92-101``), as both packages' plans."""
    g = Graph.erdos_renyi(32, 0.5, seed=2)
    part = connectivity_preserving_partition(g, 4)
    cand = np.random.default_rng(0).integers(0, 2 ** min(part.sizes),
                                             size=(part.m, K_MERGE))
    jg = jgraph.Graph.erdos_renyi(32, 0.5, seed=2)
    jplan = jmerge.build_merge_plan(jpart.connectivity_preserving_partition(jg, 4),
                                    cand, K_MERGE)
    return part, tmerge.build_merge_plan(part, cand, K_MERGE), jplan


@pytest.mark.parametrize("split,proven", [(1, False), (1, True), (2, True), (3, True)])
def test_each_stripe_matches_jax_merge_scan(split, proven):
    part, plan, jplan = _merge_instance()
    width = (tmerge.striped_beam_width(K_MERGE, part.m, D_MERGE, split)
             if proven else 16)
    ids = torch.arange(D_MERGE)
    got = tmerge.merge_scan(plan, width, shard_id=ids, n_shards=D_MERGE,
                            split_level=split)
    vals, assigns = [], []
    for s in range(D_MERGE):
        want = jmerge.merge_scan(jplan, width, shard_id=s, n_shards=D_MERGE,
                                 split_level=split)
        assert float(got.cut_value[s]) == float(want.cut_value), s
        np.testing.assert_array_equal(got.assignment[s].numpy(),
                                      np.asarray(want.assignment))
        np.testing.assert_array_equal(got.beam_score[s].numpy(),
                                      np.asarray(want.beam_score))
        one = tmerge.merge_scan(plan, width, shard_id=s, n_shards=D_MERGE,
                                split_level=split)  # one stripe, as JAX takes it
        assert torch.equal(one.assignment, got.assignment[s])
        vals.append(float(want.cut_value))
        assigns.append(np.asarray(want.assignment))
    assign, value = tmerge.global_winner(got, LocalAxis(D_MERGE), ids)
    best = max(vals)
    winner = min(s for s, v in enumerate(vals) if v >= best)
    assert float(value) == best
    np.testing.assert_array_equal(assign.numpy(), assigns[winner])
    sharded = tdist.merge_sharded(plan, width, "data=8", split_level=split)
    assert torch.equal(sharded[0], assign) and float(sharded[1]) == best
    if proven:
        exact = jmerge.merge_scan(jplan, jmerge.exact_beam_width(K_MERGE, part.m))
        assert best == float(exact.cut_value)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_striped_beam_width_matches_jax(k):
    for m in (1, 2, 3, 5, 8, 12):
        for d in (1, 2, 3, 4, 8):
            for split in (0, 1, 2, 4):
                for cap in (64, 1 << 12, 1 << 22):
                    assert (tmerge.striped_beam_width(k, m, d, split, cap=cap)
                            == jmerge.striped_beam_width(k, m, d, split, cap=cap))
    assert tmerge.striped_beam_width(2, 30, 4, 2) is None  # 2·2^30 > 2^22


def test_global_winner_takes_the_lowest_shard_among_equal_values():
    values = torch.tensor([3.0, 5.0, 4.0, 5.0])
    assigns = torch.arange(4, dtype=torch.int8)[:, None].expand(4, 6)
    res = tmerge.MergeResult(assigns, values, None, None)
    assign, best = tmerge.global_winner(res, LocalAxis(4), torch.arange(4))
    assert float(best) == 5.0 and assign.tolist() == [1] * 6
    res = tmerge.MergeResult(assigns, torch.full((4,), 2.0), None, None)
    assign, _ = tmerge.global_winner(res, LocalAxis(4), torch.arange(4))
    assert assign.tolist() == [0] * 6


@pytest.mark.parametrize("with_linear", [False, True])
@pytest.mark.parametrize("data", [1, 2, 3, 4, 8])
def test_solve_pool_is_bitwise_the_single_batch(data, with_linear):
    g = Graph.erdos_renyi(30, 0.3, seed=11)
    part = partition_for_solver(g, 6)
    assert part.m < 8  # data=8 pads more rows than the batch holds
    cfg = tqaoa.QAOAConfig(n_qubits=6, p_layers=2, opt_steps=3, top_k=2)
    edges, weights, masks = tqaoa.pad_subgraph_arrays(part.subgraphs, 6)
    linears = None
    if with_linear:
        h = np.random.default_rng(3).normal(size=g.n).astype(np.float32)
        linears = tqaoa.pad_linear_arrays(split_linear(part, h), 6)
    want = tqaoa.solve_subgraph_batch(edges, weights, masks, cfg, linear=linears)
    got = tdist.solve_pool(edges, weights, masks, cfg, {"data": data},
                           linears=linears)
    for field, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), field


def test_solve_pool_of_one_row_is_bitwise_the_row_alone():
    """One subgraph of n = k qubits padded to two rows: the plain group
    product of a batch of one would take a matrix-vector BLAS route of its
    own (`ref.mixer_group` runs it as two rows)."""
    g = Graph.erdos_renyi(6, 0.5, seed=0)
    cfg = tqaoa.QAOAConfig(n_qubits=6, p_layers=2, opt_steps=2, top_k=2)
    edges, weights, masks = tqaoa.pad_subgraph_arrays([g], 6)
    want = tqaoa.solve_subgraph_batch(edges, weights, masks, cfg)
    got = tdist.solve_pool(edges, weights, masks, cfg, "data=2")
    for field, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), field


@pytest.mark.parametrize("check", ["solve_distributed", "problem_distributed"])
def test_ported_jax_checks_are_all_true(check, capsys):
    result = _dist_checks.main([check, "--device", "cpu"])
    assert result and all(v is True for v in result.values()), result
    assert capsys.readouterr().out.strip().startswith("{")


def test_pod_and_data_mesh_stripes_over_data_only():
    g = Graph.erdos_renyi(40, 0.3, seed=2)
    cfg = tpara.ParaQAOAConfig(n_qubits=7, top_k=2, p_layers=2, opt_steps=2)
    want = tpara.solve(g, cfg, device="cpu")
    got = tdist.solve_distributed(g, cfg, "pod=2,data=2", device="cpu")
    extra = got.report.extra
    assert extra["mesh"] == {"pod": 2, "data": 2}
    assert extra["merge_shards"] == 2  # the innermost data axis; pod replicates
    assert got.cut_value == want.cut_value
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.candidates, want.candidates)


def test_merge_modes_on_a_data_mesh():
    g = Graph.erdos_renyi(40, 0.3, seed=2)
    cfg = tpara.ParaQAOAConfig(n_qubits=7, top_k=2, p_layers=2, opt_steps=2)
    want = tpara.solve(g, cfg, device="cpu")
    single = tdist.solve_distributed(g, cfg, "data=4", merge_mode="single",
                                     device="cpu")
    assert single.report.extra["merge_shards"] == 1
    assert single.report.extra["merge_per_shard_beam"] is None
    assert single.cut_value == want.cut_value
    # a beam too narrow to be exhaustive: auto keeps one device, striped
    # splits it over the shards (max(ceil(bw / D), 2K) rows each)
    narrow = tpara.ParaQAOAConfig(n_qubits=7, top_k=2, p_layers=2, opt_steps=2,
                                  beam_width=8)
    auto = tdist.solve_distributed(g, narrow, "data=4", device="cpu")
    striped = tdist.solve_distributed(g, narrow, "data=4", merge_mode="striped",
                                      device="cpu")
    assert auto.report.extra["merge_shards"] == 1
    assert auto.cut_value == tpara.solve(g, narrow, device="cpu").cut_value
    assert striped.report.extra["merge_shards"] == 4
    assert striped.report.extra["merge_per_shard_beam"] == 4
    assert np.isfinite(striped.cut_value)


def test_unknown_merge_mode_and_oversized_subgraphs_raise():
    g = Graph.erdos_renyi(30, 0.3, seed=1)
    cfg = tpara.ParaQAOAConfig(n_qubits=6, opt_steps=0)
    with pytest.raises(ValueError, match="unknown merge_mode"):
        tdist.solve_distributed(g, cfg, "data=2", merge_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="no `model` axis"):
        tdist.solve_distributed(g, cfg, "data=2", partition=partition_for_solver(g, 8),
                                device="cpu")


def test_mesh_roles_and_order():
    mesh = tdist.as_mesh({"model": 2, "data": 3, "pod": 2}, "cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"pod": 2, "data": 3, "model": 2}
    assert mesh.data_axes == ("pod", "data") and mesh.model.size == 2
    assert mesh.over(("pod", "data")).size == 6 and mesh.over(("data",)).size == 3
    with pytest.raises(ValueError, match="power of two"):
        tdist.as_mesh({"model": 3}, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        LocalAxis(3).h


_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import ParaQAOAConfig
from repro_torch.core.distributed import solve_distributed
from repro_torch.core.graph import Graph

spec, out_dir = sys.argv[1], sys.argv[2]
g = Graph.erdos_renyi(40, 0.3, seed=5)
cfg = ParaQAOAConfig(n_qubits=6, top_k=2, p_layers=2, opt_steps=3, sharded_opt_steps=2)
sol = solve_distributed(g, cfg, spec, device="cpu")
np.savez(os.path.join(out_dir, f"rank{os.environ['RANK']}.npz"),
         assignment=sol.assignment, cut=np.float64(sol.cut_value),
         candidates=sol.candidates, shards=sol.report.extra["merge_shards"],
         sharded=sol.report.extra["sharded_subproblems"],
         axis=np.array(sol.report.extra["axis"]))
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("spec,world", [("data=2", 2), ("data=2,model=2", 4),
                                        ("pod=2,data=2", 4)])
def test_ranks_over_gloo_match_one_process(tmp_path, spec, world):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, spec, str(tmp_path)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:  # each rank's own limit: a hung new_group fails here
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    g = Graph.erdos_renyi(40, 0.3, seed=5)
    cfg = tpara.ParaQAOAConfig(n_qubits=6, top_k=2, p_layers=2, opt_steps=3,
                               sharded_opt_steps=2)
    want = tdist.solve_distributed(g, cfg, spec, device="cpu")
    assert want.report.extra["merge_shards"] == 2
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert float(got["cut"]) == want.cut_value
        np.testing.assert_array_equal(got["assignment"], want.assignment)
        np.testing.assert_array_equal(got["candidates"], want.candidates)
        assert int(got["shards"]) == 2
        assert int(got["sharded"]) == want.report.extra["sharded_subproblems"]
        assert "ProcessGroupAxis" in str(got["axis"])
    if "model" in spec:
        assert want.report.extra["sharded_subproblems"] > 0
