"""The reference against the solver's plain PyTorch path on the CPU, and
against first principles at a few qubits."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from perfbench.reference import merge, partition, qaoa, refine
from perfbench.tests import tiny


@pytest.mark.parametrize("family", ["er", "torus"])
def test_solver_matches_reference_on_tiny_cells(family):
    result, checks, correct = tiny.run(family)
    nums = {name: value for name, value, _ in checks}
    assert correct, checks
    assert result["attempted"] >= 1
    assert nums["partition_diff"] == nums["merge_diff"] == nums["value_diff"] == 0
    assert nums["qaoa_exp_err"] < 1e-5 and nums["qaoa_prob_err"] < 1e-5


def _dense_state(c, gammas, betas):
    """The p-layer state through dense 2^n × 2^n unitaries, complex128."""
    n = int(np.log2(c.shape[0]))
    rx = lambda b: np.array([[np.cos(b), -1j * np.sin(b)], [-1j * np.sin(b), np.cos(b)]])
    psi = np.full(2**n, 2 ** (-n / 2), dtype=complex)
    for g, b in zip(gammas, betas):
        psi = np.exp(-1j * g * c) * psi
        u = np.ones((1, 1))
        for _ in range(n):
            u = np.kron(rx(b), u)
        psi = u @ psi
    return psi


def test_qaoa_expectation_and_gradient_against_dense_unitaries():
    n, p = 5, 3
    edges = np.array([[[0, 1], [1, 2], [2, 3], [3, 4], [0, 4], [1, 3]]])
    weights = np.array([[1.0, -1.0, 1.0, 1.0, 2.0, 0.5]])
    c = qaoa.cut_tables(n, edges, weights, torch.float64, "cpu")
    gam = torch.tensor([[0.3, 0.5, 0.7]], dtype=torch.float64)
    bet = torch.tensor([[0.6, 0.4, 0.2]], dtype=torch.float64)
    e, dg, db = qaoa.expectation_and_grad(c, gam, bet, "float64")
    cn = c[0].numpy()
    exp = lambda g, b: float(np.sum(np.abs(_dense_state(cn, g, b)) ** 2 * cn))
    assert float(e[0]) == pytest.approx(exp(gam[0].numpy(), bet[0].numpy()), abs=1e-12)
    h = 1e-6
    for l in range(p):
        for grad, which in ((dg, 0), (db, 1)):
            a = [gam[0].numpy().copy(), bet[0].numpy().copy()]
            b = [gam[0].numpy().copy(), bet[0].numpy().copy()]
            a[which][l] += h
            b[which][l] -= h
            fd = (exp(*a) - exp(*b)) / (2 * h)
            assert float(grad[0, l]) == pytest.approx(fd, abs=1e-7)
    probs = qaoa.probabilities(c, gam, bet, "float64")[0].numpy()
    np.testing.assert_allclose(probs, np.abs(_dense_state(cn, gam[0].numpy(),
                                                          bet[0].numpy())) ** 2, atol=1e-13)


def test_cut_table_counts_crossed_weight():
    edges = np.array([[[0, 2], [1, 2]]])
    c = qaoa.cut_tables(3, edges, np.array([[2.0, 3.0]]), torch.float64, "cpu")[0]
    for x in range(8):
        bit = lambda q: (x >> q) & 1
        assert float(c[x]) == 2.0 * (bit(0) != bit(2)) + 3.0 * (bit(1) != bit(2))


def test_partition_ranges_share_one_vertex_and_fit():
    for n, nq in ((400, 26), (400, 24), (16000, 20), (20000, 20), (41, 8)):
        m = partition.n_ranges(n, nq)
        rngs = partition.ranges(n, m)
        assert rngs[0][0] == 0 and rngs[-1][1] == n
        assert all(b - a <= nq for a, b in rngs)
        assert all(rngs[i][1] - 1 == rngs[i + 1][0] for i in range(m - 1))
    assert partition.n_ranges(400, 24) == 18
    assert partition.n_ranges(400, 26) == 16
    assert partition.n_ranges(16000, 20) == 843
    assert partition.n_ranges(20000, 20) == 1053


def test_split_edges_by_brute_force():
    rng = np.random.default_rng(3)
    n = 50
    rngs = partition.ranges(n, partition.n_ranges(n, 8))
    a, b = rng.integers(0, n, 300), rng.integers(0, n, 300)
    keep = a != b
    edges = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], 1)[keep], axis=0)
    got = partition.split_edges(edges, rngs)
    for (u, v), g in zip(edges, got):
        inside = [i for i, (lo, hi) in enumerate(rngs) if lo <= u and v < hi]
        assert g == (inside[0] if inside else -1)


def test_exhaustive_merge_finds_the_best_orientation():
    """With a beam of 2·K^M the merge is the best of every combination of
    candidates and orientations."""
    rng = np.random.default_rng(5)
    n, nq, k = 20, 6, 2
    rngs = partition.ranges(n, partition.n_ranges(n, nq))
    edges = np.array([(u, v) for u in range(n) for v in range(u + 1, n) if rng.random() < 0.3])
    weights = rng.choice([-1.0, 1.0], size=len(edges))
    cands = np.array([[rng.integers(0, 2 ** (hi - lo)) for _ in range(k)] for lo, hi in rngs])
    x, score = merge.merge(n, edges, weights, rngs, cands, 2 * k ** len(rngs))
    cut = lambda y: float(np.sum(weights * (y[edges[:, 0]] != y[edges[:, 1]])))
    assert score == pytest.approx(cut(x))
    best = -np.inf
    for pick in itertools.product(range(k), repeat=len(rngs)):
        for flip0 in (0, 1):
            y = np.zeros(n, dtype=np.int8)
            for i, ((lo, hi), j) in enumerate(zip(rngs, pick)):
                bits = (int(cands[i, j]) >> np.arange(hi - lo)) & 1
                f = flip0 if i == 0 else bits[0] ^ y[lo]
                y[lo:hi] = bits ^ f
            best = max(best, cut(y))
    assert score == pytest.approx(best)


def test_refine_takes_best_flips_until_none_gains():
    rng = np.random.default_rng(9)
    n = 30
    edges = np.array([(u, v) for u in range(n) for v in range(u + 1, n) if rng.random() < 0.2])
    weights = np.ones(len(edges))
    x0 = rng.integers(0, 2, n).astype(np.int8)
    x = refine.refine(n, edges, weights, x0, 1000)
    gain = lambda y, v: sum(w * (1 if y[a] == y[b] else -1) for (a, b), w in zip(edges, weights)
                            if v in (a, b))
    assert max(gain(x, v) for v in range(n)) <= 0
    # one step flips the first vertex of largest gain
    g0 = [gain(x0, v) for v in range(n)]
    x1 = refine.refine(n, edges, weights, x0, 1)
    assert np.flatnonzero(x1 != x0).tolist() == [int(np.argmax(g0))]
