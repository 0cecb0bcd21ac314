"""The benchmark's view of a solve in rounds, on the CPU.

- the readers of the round timings (``qaoa_round_s``, ``round_gap_s``):
  each the mean over the window's solves of its timing, nothing where the
  solver records no such timing;
- a tiny cell whose solves run in two rounds of 3 rows (the planner forced
  to 3) comes out correct with each round's batch recorded, and out not
  correct when a round is broken underneath: the second round's rows left
  at the ramp, or the second round's rows written over the first's; the
  first fault at the committed cell's own sampling of rows too;
- the G-set cell's configuration runs the solver of ``paraqaoa-n26``.
"""

import dataclasses
import importlib
import json

import pytest
import torch

from perfbench.lib import spec as spec_mod
from perfbench.lib.bench import Window
from perfbench.tests import tiny

ROUNDS = ("qaoa_round_s", "round_gap_s")
STAGES = {"partition_s": 0.007, "solve_s": 25.2, "merge_s": 0.42, "refine_s": 0.0,
          "total_s": 25.6, "rounds": 2, "rows_per_round": 16}
ROWS = 3  # a round of the tiny cells' 6 subgraphs


def _window(timings):
    return Window(config={}, rows=32, timings=timings, window_s=51.0)


@pytest.mark.parametrize("name", ROUNDS)
def test_reader_is_the_mean_of_its_timing(name):
    read = importlib.import_module(f"perfbench.metrics.{name}").read
    timings = [dict(STAGES, **{r: 0.5 + i for r in ROUNDS}) for i in range(3)]
    assert read(_window(timings), print) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ROUNDS)
def test_reader_gives_nothing_without_the_spans(name):
    read = importlib.import_module(f"perfbench.metrics.{name}").read
    assert read(_window([dict(STAGES) for _ in range(2)]), print) is None


@pytest.fixture
def two_rounds(monkeypatch):
    from repro_torch.core import qaoa

    monkeypatch.setattr(qaoa, "max_rows_per_round", lambda n, p, device: ROWS)


def _second_round_at_the_ramp(monkeypatch):
    """Every second call of `solve_batch_on_device` (each solve's second
    round) takes no Adam step."""
    from repro_torch.core import qaoa

    inner, calls = qaoa.solve_batch_on_device, []

    def ramp(edges, weights, cfg, linear=None):
        calls.append(1)
        if len(calls) % 2 == 0:
            cfg = dataclasses.replace(cfg, opt_steps=0)
        return inner(edges, weights, cfg, linear)

    monkeypatch.setattr(qaoa, "solve_batch_on_device", ramp)


def _second_round_over_the_first(monkeypatch):
    """The joined result holds the second round's rows in the first's."""
    from repro_torch.core import qaoa

    inner = qaoa.solve_subgraph_batch

    def overwritten(*a, **k):
        res = inner(*a, **k)
        return qaoa.QAOAResult(*(torch.cat([t[ROWS:2 * ROWS], t[ROWS:]]) for t in res))

    monkeypatch.setattr(qaoa, "solve_subgraph_batch", overwritten)


FAULTS = {"second_round_at_the_ramp": _second_round_at_the_ramp,
          "second_round_over_the_first": _second_round_over_the_first}


@pytest.mark.parametrize("family", ["er", "torus"])
def test_a_two_round_cell_is_correct(monkeypatch, two_rounds, family):
    from repro_torch.core import qaoa

    batches = []
    inner = qaoa.solve_batch_on_device

    def counted(edges, *a, **k):
        batches.append(int(edges.shape[0]))
        return inner(edges, *a, **k)

    monkeypatch.setattr(qaoa, "solve_batch_on_device", counted)
    result, checks, correct = tiny.run(family)
    assert correct, checks
    assert batches == [ROWS, ROWS] * (result["attempted"] + 1)  # and the warm-up's


@pytest.mark.parametrize("family", ["er", "torus"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_round_is_not_correct(monkeypatch, two_rounds, fault, family):
    FAULTS[fault](monkeypatch)
    _, checks, correct = tiny.run(family)
    assert not correct, checks


@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_a_round_at_the_ramp_is_caught_at_the_cells_own_sampling(monkeypatch, two_rounds,
                                                                 seed):
    cell = json.loads((spec_mod.BENCH / "cells" / "n26-g1-800.json").read_text())
    _second_round_at_the_ramp(monkeypatch)
    _, checks, correct = tiny.run("er", seed=seed, qaoa_rows=int(cell["qaoa_rows"]))
    assert not correct, checks


def test_the_gset_cell_runs_the_n26_solver():
    g1, er = spec_mod.load("n26-g1-800"), spec_mod.load("n26-er400")
    assert g1.config == er.config and g1.cell["limits"] == er.cell["limits"]
    assert (g1.traffic["family"], g1.traffic["n"], g1.traffic["p"]) == ("er", 800, 0.06)
    assert [m["name"] for m in g1.per_layer][-2:] == list(ROUNDS)
