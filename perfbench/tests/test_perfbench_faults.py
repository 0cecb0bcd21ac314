"""A run whose timed path is broken underneath comes out not correct: the
harness's run without its look for a chip, on the CPU at a small size,
once for each fault the cells can have (one chip: no exchange to leave
out)."""

import json

import numpy as np
import pytest
import torch

from perfbench.lib import check, spec as spec_mod
from perfbench.tests import tiny


def _adam_does_nothing(monkeypatch):
    from repro_torch.core import engine

    monkeypatch.setattr(engine, "adam_scan", lambda grad_fn, params, steps, lr: params)


def _half_the_batch(monkeypatch):
    """Only the first half of the subgraphs is solved; the rest get the
    first row's answer."""
    from repro_torch.core import qaoa

    inner = qaoa.solve_subgraph_batch

    def half(edges, weights, masks, cfg, linear=None):
        h = max(1, edges.shape[0] // 2)
        res = inner(edges[:h], weights[:h], masks[:h], cfg, linear=linear)
        fill = lambda t: torch.cat([t, t[:1].expand(edges.shape[0] - h, *t.shape[1:])])
        return qaoa.QAOAResult(*(fill(t) for t in res))

    monkeypatch.setattr(qaoa, "solve_subgraph_batch", half)


def _candidate_altered(monkeypatch):
    from repro_torch.core import qaoa

    inner = qaoa.solve_subgraph_batch

    def altered(*a, **k):
        res = inner(*a, **k)
        bits = res.bitstrings.clone()
        bits[0, 0] ^= 0b110  # two vertices of the first subgraph's best candidate
        return res._replace(bitstrings=bits)

    monkeypatch.setattr(qaoa, "solve_subgraph_batch", altered)


def _answer_altered(monkeypatch):
    from repro_torch.core import paraqaoa

    inner = paraqaoa.refine_merged

    def altered(graph, *a, **k):
        x, _ = inner(graph, *a, **k)
        x = np.array(x, copy=True)
        x[0] ^= 1
        e = graph.edges[:graph.n_edges].numpy()
        w = graph.weights[:graph.n_edges].numpy()
        return x, float(np.sum(w * (x[e[:, 0]] != x[e[:, 1]])))  # its own value

    monkeypatch.setattr(paraqaoa, "refine_merged", altered)


FAULTS = {"adam_does_nothing": _adam_does_nothing, "half_the_batch": _half_the_batch,
          "candidate_altered": _candidate_altered, "answer_altered": _answer_altered}


@pytest.mark.parametrize("family", ["er", "torus"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, fault, family):
    FAULTS[fault](monkeypatch)
    _, checks, correct = tiny.run(family)
    assert not correct, checks


def _cell_qaoa_rows() -> int:
    """The rows of the window's QAOA that the committed cell checks."""
    cell = json.loads((spec_mod.BENCH / "cells" / "n26-er400.json").read_text())
    return int(cell["qaoa_rows"])


@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103, 2**31 + 104])
def test_half_the_batch_is_caught_at_the_cells_own_sampling(monkeypatch, seed):
    _half_the_batch(monkeypatch)
    _, checks, correct = tiny.run("er", seed=seed, qaoa_rows=_cell_qaoa_rows())
    assert not correct, checks


def test_the_drawn_rows_span_each_half_of_the_batch():
    count = _cell_qaoa_rows()
    for seed in range(2**31, 2**31 + 500):
        for rows in ([16] * 4, [16, 15, 16], [6]):
            drawn = check.draw_rows(seed, rows, count)
            assert len(drawn) == min(count, sum(rows))
            assert any(2 * r < rows[i] for i, r in drawn), (seed, drawn)
            assert any(2 * r >= rows[i] for i, r in drawn), (seed, drawn)
