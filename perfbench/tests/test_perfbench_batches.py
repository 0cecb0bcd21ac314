"""Each QAOA kernel launch is priced at the rows of its own batch: the
roofline reader on synthetic windows of one batch, two equal batches and
three uneven ones, and the harness's record of the batches through the
solver on the CPU, in one batch a solve and in two rounds."""

import numpy as np
import pytest
import torch

from perfbench.lib import bench, generate
from perfbench.lib.bench import Card, Window
from perfbench.lib.counts import kernel_counts, least_s_of
from perfbench.lib.devtrace import Reading
from perfbench.metrics import kernels_roofline
from perfbench.tests import tiny

N = 26
# launches of one call of solve_batch_on_device at n26-er400's settings
PER_CALL = {"cutvals": 1, "fused_phase_mixer_group": 363, "mixer_group_strided": 726,
            "beta_grad": 180, "phase_grad": 180, "expectation": 61}
# device time of one solve's kernels (ns), whatever its batches
OPS = [("cutvals_fill<4>", 0, 2_700_000), ("fused_kernel<true>", 1, 2_574_000_000),
       ("mixer_strided_kernel", 2, 5_090_000_000), ("beta_grad_kernel<5>", 3, 1_365_000_000),
       ("beta_grad_kernel<0>", 4, 965_000_000), ("phase_grad_partial_kernel", 5, 1_230_000_000),
       ("expectation_partial_kernel", 6, 250_000_000),
       ("elementwise_kernel<128, 4>", 7, 1_100_000_000)]


def _window(batches, calls=None):
    calls = len(batches) if calls is None else calls
    card = Card(peak=0, batches=batches,
                launches={op: k * calls for op, k in PER_CALL.items()},
                trace=Reading(ops=OPS, busy_s=12.6, window_s=13.0, gaps=[]))
    return Window(config={"n_qubits": N}, rows=sum(batches), timings=[{}], window_s=13.0,
                  cards=[card])


def _share_by_batch(batches):
    """Σ over the batches of each launch at that batch's rows, over the
    device time of the counted kernels."""
    counts = kernel_counts()
    least = sum(PER_CALL.get(m.OP, 0) * least_s_of(m, rows, N)
                for rows in batches for m in counts.values())
    covered = sum(d for name, _, d in OPS if not name.startswith("elementwise"))
    return 100.0 * least / (covered / 1e9)


def test_one_batch_reads_the_whole_solves_rows():
    counts = kernel_counts()
    w = _window([16])
    # the formula before batches were recorded: every launch at the solve's rows
    least = sum(w.cards[0].launches.get(m.OP, 0) * least_s_of(m, w.rows, N)
                for m in counts.values())
    covered = sum(d for name, _, d in OPS if not name.startswith("elementwise"))
    lines = []
    assert kernels_roofline.read(w, lines.append) == 100.0 * least / (covered / 1e9)
    assert "batches [16], cutvals launches 1;" in lines[0]


def test_two_batches_of_half_the_rows_read_the_same():
    one = kernels_roofline.read(_window([16]), print)
    assert kernels_roofline.read(_window([8, 8]), print) == pytest.approx(one, rel=1e-12)
    assert 50 < one < 100


def test_uneven_batches_read_by_linearity():
    assert kernels_roofline.read(_window([11, 11, 10]), print) == pytest.approx(
        _share_by_batch([11, 11, 10]), rel=1e-12)
    assert _share_by_batch([11, 11, 10]) == pytest.approx(2 * _share_by_batch([16]))


@pytest.mark.parametrize("batches, calls", [([8, 8], 1), ([16], 2), ([], 1), ([], 0)])
def test_a_window_whose_cost_tables_miss_its_batches_reads_nothing(batches, calls):
    lines = []
    assert kernels_roofline.read(_window(batches, calls), lines.append) is None
    assert "no share" in lines[0]


def _solves(seed, count=2):
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve

    sp = tiny.spec("er")
    cfg = ParaQAOAConfig(**sp.config)
    insts = [generate.instance(sp.traffic, seed, i) for i in range(count)]
    return [solve(bench.graph_of(Graph, inst), cfg, device="cpu") for inst in insts]


def test_the_harness_records_one_batch_of_m_rows_a_solve():
    from repro_torch.core import qaoa

    batches = []
    with bench.capture_batches(qaoa, batches):
        outs = _solves(2**31 + 21)
    assert batches == [out.partition.m for out in outs]
    assert all(m > 1 for m in batches)


def _in_two_rounds(monkeypatch):
    """``solve_subgraph_batch`` as a solve in two rounds: one call of
    ``solve_batch_on_device`` on each half of the rows, joined."""
    from repro_torch.core import qaoa

    def rounds(edges, weights, real_mask, cfg, linear=None):
        h = edges.shape[0] // 2
        parts = [qaoa.solve_batch_on_device(edges[s], weights[s], cfg,
                                            None if linear is None else linear[s])
                 for s in (slice(0, h), slice(h, None))]
        gammas, betas, re, im, exp = (torch.cat(t) for t in zip(*parts))
        bits, probs = qaoa.topk_marginal(re, im, cfg.n_qubits, real_mask, cfg.top_k)
        return qaoa.QAOAResult(bits, probs, exp, gammas, betas)

    monkeypatch.setattr(qaoa, "solve_subgraph_batch", rounds)


def test_a_solve_in_two_rounds_records_two_batches(monkeypatch):
    from repro_torch.core import qaoa

    seed = 2**31 + 22
    whole = _solves(seed)
    _in_two_rounds(monkeypatch)
    batches = []
    with bench.capture_batches(qaoa, batches):
        outs = _solves(seed)
    ms = [out.partition.m for out in outs]
    assert batches == [r for m in ms for r in (m // 2, m - m // 2)]
    for out, ref in zip(outs, whole):
        assert out.qaoa.probs.shape[0] == out.partition.m
        np.testing.assert_array_equal(out.qaoa.bitstrings.numpy(), ref.qaoa.bitstrings.numpy())
    # and the check judges every row of a run in rounds
    _, checks, correct = tiny.run("er", seed=seed)
    assert correct, checks
