"""A cell over the cards of one host, on the CPU: the tiny cell over
``data=4`` run by ``run.py``'s rank path, four processes over gloo; the
reading rules over cards on fabricated readings (one card: the formulas of
a run on one card, to the last bit; four equal cards: one card's shares,
the mean idle share and the fullest card's peak); a cell's chips against
its mesh; a rank that fails, or a run past its allowance, ending the run
with no result; the exchange between the ranks left out, which the check
fails; and the QAOA stage that the harness reads from a solve over a
mesh."""

import json
import multiprocessing
import time

import numpy as np
import pytest
import torch

from perfbench import run as run_mod
from perfbench.counts import qaoa_stage
from perfbench.lib import bench, generate, peaks, ranks, spec as spec_mod
from perfbench.lib.bench import Card, Window
from perfbench.lib.counts import kernel_counts, least_s_of, owner
from perfbench.lib.devtrace import Reading
from perfbench.metrics import device_idle, kernels_roofline, qaoa_mfu
from perfbench.tests import tiny

SEED = 2**31 + 401
N, ROWS = 26, 32
PER_CALL = {"cutvals": 1, "fused_phase_mixer_group": 363, "mixer_group_strided": 726,
            "beta_grad": 180, "phase_grad": 180, "expectation": 61}
OPS = [("cutvals_fill<4>", 0, 2_700_000), ("fused_kernel<true>", 1, 2_574_000_001),
       ("mixer_strided_kernel<2>", 2, 5_090_000_003), ("beta_grad_kernel<5>", 3, 1_365_000_007),
       ("expectation_partial_kernel", 6, 250_000_009),
       ("elementwise_kernel<128, 4>", 7, 1_100_000_011)]
TIMINGS = [{"solve_s": 10.512345}, {"solve_s": 10.498765}]


def _card(peak=64_466_483_200, busy=52.13, window=52.32, batches=(16,), ops=OPS,
          gaps=((0.022, "merge_plan"), (0.016, "between solves"))):
    return Card(peak=peak, batches=list(batches),
                launches={op: k * len(batches) for op, k in PER_CALL.items()},
                trace=Reading(ops=list(ops), busy_s=busy, window_s=window, gaps=list(gaps)))


def _window(cards, rows=ROWS):
    return Window(config={"n_qubits": N, "p_layers": 3, "opt_steps": 60}, rows=rows,
                  timings=TIMINGS, window_s=21.0, chips=len(cards), cards=cards)


# the formulas of a run on one card, as they read before there were cards
def _roofline_of_one_card(w, card):
    rows = sum(card.batches) / len(card.batches)
    counts = kernel_counts()
    spent = dict.fromkeys(counts, 0)
    for name, _, dur in card.trace.ops:
        mod = owner(name, counts)
        if mod is not None:
            spent[mod.__name__.rsplit(".", 1)[1]] += dur
    least = {k: card.launches.get(m.OP, 0) * least_s_of(m, rows, w.config["n_qubits"])
             for k, m in counts.items()}
    return 100.0 * sum(least[k] for k in counts if spent[k]) / (sum(spent.values()) / 1e9)


def _mfu_of_one_card(w):
    c = w.config
    least = peaks.least_s(*qaoa_stage.work(w.rows, c["n_qubits"], c["p_layers"],
                                           c["opt_steps"]))
    return 100.0 * least * len(w.timings) / sum(t["solve_s"] for t in w.timings)


def test_one_card_reads_as_a_run_on_one_card_to_the_last_bit():
    card = _card()
    w = _window([card])
    assert kernels_roofline.read(w, lambda line: None) == _roofline_of_one_card(w, card)
    assert qaoa_mfu.read(w, None) == _mfu_of_one_card(w)
    assert device_idle.read(w, None) == 1.0 - card.trace.busy_s / card.trace.window_s
    dev = bench.device_of([card], 1, torch.device("cpu"))
    assert dev["memory_peak_bytes"] == card.peak and dev["count"] == 1
    assert (dev["busy_s"], dev["window_s"]) == (card.trace.busy_s, card.trace.window_s)
    bd = bench._breakdown([card])
    assert bd["idle_gaps"] == [["merge_plan", 0.022], ["between solves", 0.016]]
    assert bd["device_ops"][0] == ["mixer_strided_kernel<2>", 5.090000003]


def test_four_equal_cards_read_one_cards_shares():
    one = _window([_card()])
    # four cards, each doing one card's work (its batches, launches and
    # device time) as its quarter of a stage of four times the rows
    cards = [_card(peak=60_000_000_000 + r, busy=52.13 - r, window=52.32) for r in range(4)]
    four = _window(cards, rows=4 * ROWS)
    assert kernels_roofline.read(four, print) == pytest.approx(kernels_roofline.read(one, print),
                                                               rel=1e-12)
    assert qaoa_mfu.read(four, None) == pytest.approx(qaoa_mfu.read(one, None), rel=1e-12)
    shares = [(52.13 - r) / 52.32 for r in range(4)]
    assert device_idle.read(four, None) == pytest.approx(1.0 - sum(shares) / 4, rel=1e-15)
    dev = bench.device_of(cards, 4, torch.device("cpu"))
    assert dev["memory_peak_bytes"] == 60_000_000_003 and dev["count"] == 4
    assert dev["busy_s"] == pytest.approx(52.13 - 1.5)
    bd = bench._breakdown(cards)
    assert bd["device_ops"][0] == ["mixer_strided_kernel<2>", pytest.approx(4 * 5.090000003)]
    assert bd["idle_gaps"][:4] == [["merge_plan@3", 0.022], ["merge_plan@2", 0.022],
                                   ["merge_plan@1", 0.022], ["merge_plan@0", 0.022]]
    assert len(bd["idle_gaps"]) == 8


def test_a_card_whose_cost_tables_miss_its_batches_leaves_no_share():
    bad = _card()
    bad.launches["cutvals"] = 2
    lines = []
    assert kernels_roofline.read(_window([_card(), bad]), lines.append) is None
    assert "on card 1: no share" in lines[0]


@pytest.mark.parametrize("chips, mesh, ok", [
    (1, None, True), (4, "data=4", True), (4, "data=2,model=2", True),
    (4, "data=2", False), (4, None, False), (1, "data=4", False)])
def test_a_cells_chips_are_its_meshs_places(chips, mesh, ok):
    if ok:
        spec_mod.check_mesh("cell", chips, mesh, "auto")
    else:
        with pytest.raises(ValueError, match=f"{chips} chips"):
            spec_mod.check_mesh("cell", chips, mesh, "auto")


def test_load_reads_the_mesh_and_checks_it(tmp_path):
    bench_json = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
    config = json.loads((spec_mod.BENCH / "configs" / "paraqaoa-n26-g1.json").read_text())
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    for sub, name in (("traffic", "g1-800"), ("cells", "n26-g1-800")):
        (tmp_path / "perfbench" / sub).mkdir()
        (tmp_path / "perfbench" / sub / f"{name}.json").write_text(
            (spec_mod.BENCH / sub / f"{name}.json").read_text())
    bench_json["workloads"] = [dict(bench_json["workloads"][1], chips=4)]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    path = tmp_path / "perfbench" / "configs" / "paraqaoa-n26-g1.json"
    for mesh, merge_mode, raises in (("data=4", "striped", None), ("data=2", "auto", "2 places"),
                                     (None, "auto", "names no mesh"),
                                     ("data=4", "ring", "merge_mode")):
        path.write_text(json.dumps(dict(config, mesh=mesh, merge_mode=merge_mode)))
        if raises:
            with pytest.raises(ValueError, match=raises):
                spec_mod.load("n26-g1-800", root=tmp_path)
        else:
            sp = spec_mod.load("n26-g1-800", root=tmp_path)
            assert (sp.chips, sp.mesh, sp.merge_mode) == (4, "data=4", "striped")


def test_a_cell_without_a_mesh_loads_as_before():
    from repro_torch.core.distributed import MERGE_MODES

    assert spec_mod.MERGE_MODES == MERGE_MODES
    for cell in ("n26-er400", "n26-g1-800"):
        sp = spec_mod.load(cell)
        assert (sp.chips, sp.mesh, sp.merge_mode) == (1, None, "auto")


def test_the_stage_of_a_mesh_solve_is_solves_to_the_bit():
    """The QAOA stage the harness keeps from a solve over ``data=4`` in one
    process (the pool's result) against ``solve``'s ``out.qaoa``, at n 8."""
    from repro_torch.core import distributed
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve

    sp = tiny.spec("er")
    cfg = ParaQAOAConfig(**sp.config)
    for i in range(2):
        graph = bench.graph_of(Graph, generate.instance(sp.traffic, SEED, i))
        one = solve(graph, cfg, device="cpu")
        stages = []
        with bench.capture_stages(distributed, stages):
            out = distributed.solve_distributed(graph, cfg, "data=4", device="cpu")
        assert out.qaoa is None
        stage = bench.stage_of(out, stages)
        for a, b in zip(one.qaoa, stage):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(out.assignment, one.assignment)


def test_a_solve_without_its_stage_is_not_correct(monkeypatch):
    monkeypatch.setattr(bench, "stage_of", lambda out, stages: None)
    result, checks, correct = tiny.run("er")
    assert not correct
    assert dict((k, v) for k, v, _ in checks)["qaoa_missing"] == result["attempted"]


def test_the_tiny_cell_over_four_ranks_reads_as_on_one_card(monkeypatch, capsys):
    seconds = 0.3
    sp = tiny.spec("er", mesh="data=4")
    kept = []
    inner = ranks.launch

    def keep(*a, **k):
        code, outcome = inner(*a, **k)
        kept.append(outcome)
        return code, outcome

    monkeypatch.setattr(ranks, "launch", keep)
    t = time.perf_counter()
    assert run_mod.run_cell(sp, SEED, seconds, False, "cpu", t) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4 and result["checks"]["qaoa_missing"]["value"] == 0
    assert kept[0][0] == result
    answers = kept[0][1]
    _, solved = bench.measure(tiny.spec("er"), SEED, seconds, False, "cpu",
                              time.perf_counter(), log=lambda line: None)
    common = min(len(answers), len(solved))
    assert common >= 1
    for a, s in zip(answers[:common], solved[:common]):
        np.testing.assert_array_equal(a, s.assignment)
    assert not multiprocessing.active_children()


def rank_without_the_exchange(*args):
    """`ranks.rank_main` with the pool's gather left out: each rank's
    gathered rows are its own block in every rank's place."""
    from repro_torch.core import axis

    axis.ProcessGroupAxis.gather_rows = lambda self, x: torch.cat([x] * self.size)
    ranks.rank_main(*args)


def test_the_exchange_left_out_is_not_correct():
    code, outcome = ranks.launch(tiny.spec("er", mesh="data=4"), SEED, 0.0, False, "cpu",
                                 time.perf_counter(), target=rank_without_the_exchange)
    assert code == 0
    line = outcome[0]
    assert not line["correct"], line["checks"]
    assert line["checks"]["qaoa_prob_err"]["value"] > line["checks"]["qaoa_prob_err"]["limit"]


def rank_failing_in_its_second_solve(*args):
    """`ranks.rank_main` with rank 1's second solve of the window raising
    (its first call is the warm-up): the other ranks wait in a collective."""
    if args[6]["RANK"] == "1":
        from repro_torch.core import distributed

        inner, calls = distributed.solve_distributed, []

        def failing(*a, **k):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("a planted fault in the second solve")
            return inner(*a, **k)

        distributed.solve_distributed = failing
    ranks.rank_main(*args)


def rank_with_jax_loaded(*args):
    """`ranks.rank_main` with a module named ``jax`` in rank 2's process."""
    if args[6]["RANK"] == "2":
        import sys
        import types

        sys.modules["jax"] = types.ModuleType("jax")
    ranks.rank_main(*args)


@pytest.mark.parametrize("case", ["second_solve_raises", "jax_on_a_rank", "past_the_allowance",
                                  "no_cards"])
def test_a_failed_run_over_ranks_prints_no_result(capsys, case):
    sp = tiny.spec("er", mesh="data=4")
    t = time.perf_counter()
    if case == "second_solve_raises":
        code, outcome = ranks.launch(sp, SEED, 30.0, False, "cpu", t,
                                     target=rank_failing_in_its_second_solve)
    elif case == "jax_on_a_rank":
        code, outcome = ranks.launch(sp, SEED, 0.0, False, "cpu", t, target=rank_with_jax_loaded)
    elif case == "past_the_allowance":
        code, outcome = ranks.launch(sp, SEED, 0.0, False, "cpu", t, allowance=1.0)
    else:  # each rank looks for the cards
        code, outcome = ranks.launch(sp, SEED, 1.0, False, "cuda", t)
    assert code != 0 and outcome is None
    assert time.perf_counter() - t < 25
    assert capsys.readouterr().out == ""
    assert not multiprocessing.active_children()


def test_a_run_on_one_card_without_it_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run_mod.run_cell(tiny.spec("er"), SEED, 1.0, False, "cuda", time.perf_counter()) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs 1 CUDA device(s); found 0" in captured.err
