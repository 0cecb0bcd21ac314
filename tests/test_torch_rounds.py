"""The batched QAOA in rounds (`qaoa.solve_subgraph_batch`, which plans
them with `qaoa.max_rows_per_round`), on the CPU.

- rounds of 3 rows on M = 6 (balanced) and M = 7 (an uneven last round)
  give the one-batch solve bit for bit: candidates, probabilities, ⟨C⟩,
  angles, answer and value (a row does not depend on its batch);
- the solver pool on a ``data=2`` mesh and the mesh solve on ``data=1``
  run their rows in the same rounds and give `solve`'s result bit for bit;
- the solve in rounds gives the JAX package's `repro.core.solve` answer,
  with the exact beam and with a pruned one (``beam_cap`` below 2·K^M). The
  instances are QUBOs with normal weights and linear terms: those break the
  complement and automorphism ties whose last ulp picks a candidate either
  way in Max-Cut (`tests/test_torch_core.py`), so the answers are equal and
  the values within f32 sums in another order;
- the planner: the split is balanced, 16 rows of 26 qubits at p = 3 are
  one round on an 80 GB H100 and 32 are two of 16, a budget of one row
  gives M rounds, a row that does not fit raises, the CPU has no limit, and
  the card plans against its memory less what is allocated.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import paraqaoa as jpara
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import paraqaoa as tpara
from repro_torch.core import qaoa as tqaoa

N_QUBITS = 8  # 7 vertices a subgraph: n = 42 → M = 6, n = 48 → M = 7
H100_BYTES = 85_017_493_504  # total_memory of an H100 80GB HBM3
N26_ROW_PEAK = 64_458_094_080 // 16  # a row of n26-er400's one batch of 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rounds_of_3(monkeypatch):
    """The planner gives rounds of 3 rows (the CPU's plan is one round)."""
    monkeypatch.setattr(tqaoa, "max_rows_per_round", lambda n, p, device: 3)


def counted_batches(monkeypatch) -> list:
    """The rows of each call of `solve_batch_on_device` from now on: one a
    round."""
    batches = []
    inner = tqaoa.solve_batch_on_device

    def counted(edges, *a, **k):
        batches.append(int(edges.shape[0]))
        return inner(edges, *a, **k)

    monkeypatch.setattr(tqaoa, "solve_batch_on_device", counted)
    return batches


def _qubo(n, seed):
    """The same random QUBO in both packages."""
    g = jgraph.Graph.erdos_renyi(n, 0.4, seed=seed)
    e = np.asarray(g.edges)[: g.n_edges]
    rng = np.random.default_rng(seed + 0x9B0)
    q = rng.normal(size=g.n_edges).astype(np.float32)
    h = rng.normal(size=n).astype(np.float32)
    return (jgraph.Problem.qubo(n, e, q, linear=h),
            tgraph.Problem.qubo(n, e, q, linear=h))


@pytest.mark.parametrize("kind", ["maxcut", "qubo"])
@pytest.mark.parametrize("n, m, sizes", [(42, 6, [3, 3]), (48, 7, [3, 3, 1])])
def test_rounds_equal_the_one_batch_solve_bit_for_bit(monkeypatch, kind, n, m, sizes):
    g = (tgraph.Graph.erdos_renyi(n, 0.3, seed=5) if kind == "maxcut"
         else _qubo(n, seed=5)[1])
    cfg = tpara.ParaQAOAConfig(n_qubits=N_QUBITS, opt_steps=5)
    batches = counted_batches(monkeypatch)
    one = tpara.solve(g, cfg, device="cpu")
    assert one.partition.m == m and batches == [m]
    batches.clear()
    rounds_of_3(monkeypatch)
    out = tpara.solve(g, cfg, device="cpu")
    assert batches == sizes
    for name, a, b in zip(tqaoa.QAOAResult._fields, one.qaoa, out.qaoa):
        assert a.shape[0] == m and torch.equal(a, b), name
    np.testing.assert_array_equal(one.candidates, out.candidates)
    np.testing.assert_array_equal(one.assignment, out.assignment)
    assert one.cut_value == out.cut_value


@pytest.mark.parametrize("path, n, m, sizes", [
    ("pool", 42, 6, [3, 3]), ("pool", 48, 7, [3, 3, 2]),
    ("mesh", 42, 6, [3, 3]), ("mesh", 48, 7, [3, 3, 1])])
def test_pool_and_mesh_solve_run_in_rounds(monkeypatch, path, n, m, sizes):
    """Rounds of 3: `distributed.solve_pool` on a ``data=2`` mesh (M = 7
    padded to 8 rows) and `solve_distributed` on ``data=1`` call the device
    part on at most 3 rows at a time, and give `solve`'s candidates, QAOA
    fields, assignment and value bit for bit."""
    g = tgraph.Graph.erdos_renyi(n, 0.3, seed=5)
    cfg = tpara.ParaQAOAConfig(n_qubits=N_QUBITS, opt_steps=5)
    one = tpara.solve(g, cfg, device="cpu")
    assert one.partition.m == m
    rounds_of_3(monkeypatch)
    batches = counted_batches(monkeypatch)
    if path == "pool":
        edges, weights, masks = tqaoa.pad_subgraph_arrays(one.partition.subgraphs,
                                                          N_QUBITS)
        res = tdist.solve_pool(edges, weights, masks, cfg.qaoa_config(),
                               "data=2")
        for name, a, b in zip(tqaoa.QAOAResult._fields, one.qaoa, res):
            assert torch.equal(a, b), name
        cands = res.bitstrings.numpy()
        assignment, cut, _ = tpara.merge_candidates(one.partition, cands, cfg)
        value = tpara.checked_value(tgraph.as_problem(g), assignment, cut, cfg)
    else:
        out = tdist.solve_distributed(g, cfg, "data=1", device="cpu")
        cands, assignment, value = out.candidates, out.assignment, out.cut_value
    assert batches == sizes
    np.testing.assert_array_equal(one.candidates, cands)
    np.testing.assert_array_equal(one.assignment, assignment)
    assert one.cut_value == value


@pytest.mark.parametrize("n, beam_cap", [(42, 1 << 18), (48, 1 << 18), (48, 32)])
def test_rounds_give_the_jax_solve(monkeypatch, n, beam_cap):
    rounds_of_3(monkeypatch)
    batches = counted_batches(monkeypatch)
    jp, tp = _qubo(n, seed=2)
    kw = dict(n_qubits=N_QUBITS, opt_steps=5, beam_cap=beam_cap)
    jout = jpara.solve(jp, jpara.ParaQAOAConfig(**kw))
    tout = tpara.solve(tp, tpara.ParaQAOAConfig(**kw), device="cpu")
    m = tout.partition.m
    assert len(batches) == -(-m // 3) > 1 and max(batches) == 3
    assert tout.report.extra["beam"] == jout.report.extra["beam"] == min(2 * 2**m, beam_cap)
    np.testing.assert_array_equal(tout.assignment, np.asarray(jout.assignment))
    np.testing.assert_allclose(tout.cut_value, jout.cut_value, rtol=1e-5)


@pytest.mark.parametrize("b, per, sizes", [
    (32, 19, [16, 16]), (16, 19, [16]), (7, 3, [3, 3, 1]), (6, 3, [3, 3]),
    (10, 4, [4, 4, 2]), (5, None, [5]), (4, 1, [1, 1, 1, 1])])
def test_round_slices_are_balanced(b, per, sizes):
    slices = tqaoa.round_slices(b, per)
    assert [s.stop - s.start for s in slices] == sizes
    assert slices[0].start == 0 and slices[-1].stop == b
    assert all(a.stop == c.start for a, c in zip(slices, slices[1:]))


def test_the_byte_fit_holds_the_measured_n26_row():
    assert tqaoa.row_bytes(26, 3) <= N26_ROW_PEAK < 1.001 * tqaoa.row_bytes(26, 3)
    assert tqaoa.row_bytes(24, 2) == 52 << 24


def test_planner_on_an_80_gb_card():
    per = tqaoa.rows_that_fit(tqaoa.row_bytes(26, 3), H100_BYTES)
    assert 16 <= per < 32
    assert tqaoa.round_slices(16, per) == [slice(0, 16)]
    assert tqaoa.round_slices(32, per) == [slice(0, 16), slice(16, 32)]


def test_planner_budget_of_one_row_and_a_row_that_does_not_fit():
    row = tqaoa.row_bytes(26, 3)
    one_row = -(-row * 10 // 9)  # MEMORY_SHARE of it is a row
    assert tqaoa.MEMORY_SHARE == 0.9
    assert tqaoa.rows_that_fit(row, one_row) == 1
    assert len(tqaoa.round_slices(32, 1)) == 32
    with pytest.raises(MemoryError, match=f"one row needs {row:,} B"):
        tqaoa.rows_that_fit(row, one_row - 16)
    with pytest.raises(MemoryError):
        tqaoa.rows_that_fit(tqaoa.row_bytes(31, 3), H100_BYTES)  # 120 GiB a row


def test_planner_reads_the_card_and_gives_no_limit_off_it(monkeypatch):
    assert tqaoa.max_rows_per_round(26, 3, "cpu") is None
    allocated = {"bytes": 0}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(total_memory=H100_BYTES))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: allocated["bytes"])
    row = tqaoa.row_bytes(26, 3)
    assert tqaoa.max_rows_per_round(26, 3, "cuda") == tqaoa.rows_that_fit(row, H100_BYTES)
    allocated["bytes"] = 60 << 30  # held by the caller: planned around
    assert tqaoa.max_rows_per_round(26, 3, "cuda") == tqaoa.rows_that_fit(
        row, H100_BYTES - (60 << 30)) == 4
