"""The readers of the solver's part timings on a synthetic window: each the
mean over the window's solves of its timing, and nothing where the solver
records no such timing (a solver without the spans)."""

import importlib

import pytest

from perfbench.lib.bench import Window

STAGES = {"partition_s": 0.002, "solve_s": 15.6, "merge_s": 0.09, "refine_s": 0.0,
          "total_s": 15.7}
PARTS = ("adam_step_s", "qaoa_tail_s", "merge_plan_s", "merge_scan_s")


def _window(timings):
    return Window(config={}, rows=16, timings=timings, window_s=62.0)


@pytest.mark.parametrize("name", PARTS)
def test_reader_is_the_mean_of_its_timing(name):
    read = importlib.import_module(f"perfbench.metrics.{name}").read
    timings = [dict(STAGES, **{p: 0.25 + i for p in PARTS}) for i in range(4)]
    assert read(_window(timings), print) == pytest.approx(1.75)


@pytest.mark.parametrize("name", PARTS)
def test_reader_gives_nothing_without_the_spans(name):
    read = importlib.import_module(f"perfbench.metrics.{name}").read
    assert read(_window([dict(STAGES) for _ in range(3)]), print) is None
