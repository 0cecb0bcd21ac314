"""The instance generator: seeded, distinct instances in a pool, and the
families' shapes."""

import json

import numpy as np
import pytest

from perfbench.lib import generate, spec

BIG_SEED = 2**31 + 4242


def _traffic(name):
    return json.loads((spec.BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["er400", "torus20k"])
def test_same_seed_same_instance(name):
    a = generate.instance(_traffic(name), BIG_SEED, 3)
    b = generate.instance(_traffic(name), BIG_SEED, 3)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("name", ["er400", "torus20k"])
def test_pool_has_no_repeats(name):
    t = _traffic(name)
    seen = set()
    for i in range(-1, 24):
        _, e, w = generate.instance(t, BIG_SEED, i)
        key = (e.tobytes(), w.tobytes())
        assert key not in seen
        seen.add(key)
    # another seed gives other instances
    _, e, w = generate.instance(t, BIG_SEED + 1, 0)
    assert (e.tobytes(), w.tobytes()) not in seen


def test_torus_has_two_n_edges_of_weight_plus_or_minus_one():
    n, e, w = generate.instance(_traffic("torus20k"), BIG_SEED, 0)
    assert n == 20000 and e.shape == (2 * n, 2)
    assert set(np.unique(w).tolist()) == {-1.0, 1.0}
    assert abs(float(np.mean(w > 0)) - 0.5) < 0.02
    assert np.all(np.bincount(e.ravel(), minlength=n) == 4)
    assert len(np.unique(e[:, 0].astype(np.int64) * n + e[:, 1])) == 2 * n
    assert np.all(e[:, 0] < e[:, 1])


def test_er_edges_are_distinct_sorted_pairs_near_the_mean():
    t = _traffic("er400")
    counts = []
    for i in range(20):
        n, e, w = generate.instance(t, BIG_SEED, i)
        assert np.all(e[:, 0] < e[:, 1]) and np.all(w == 1.0)
        key = e[:, 0].astype(np.int64) * n + e[:, 1]
        assert np.all(np.diff(key) > 0)  # sorted, no pair twice
        counts.append(len(e))
    mean = 0.1 * 400 * 399 / 2
    sd = np.sqrt(mean * 0.9)
    assert abs(np.mean(counts) - mean) < 4 * sd / np.sqrt(20)
    assert np.std(counts) == pytest.approx(sd, rel=0.5)


def test_er_pairs_are_uniform():
    """Every pair of a small G(n, p) turns up equally often."""
    t = {"family": "er", "n": 8, "p": 0.5, "weights": "unit"}
    hits = np.zeros((8, 8))
    for i in range(2000):
        _, e, _ = generate.instance(t, 7, i)
        hits[e[:, 0], e[:, 1]] += 1
    freq = hits[np.triu_indices(8, 1)] / 2000
    assert np.all(np.abs(freq - 0.5) < 0.05)


def test_large_seeds_and_negative_seeds_are_taken():
    for s in (0, 2**31 + 1, 2**40, -5):
        n, e, _ = generate.instance(_traffic("er400"), s, 0)
        assert n == 400 and len(e) > 7000
