"""The one instance generator: a traffic file names a graph family and its
parameters, and every instance is drawn from (seed, index) alone.

Families:
  ``er``     G(n, p): the edge count from its binomial law, then that many
             distinct vertex pairs, uniformly. Pairs are drawn as two
             vertices at a time, so no table of all n(n − 1)/2 pairs is
             ever made (128M pairs at n = 16,000); they are drawn and
             sorted by torch on ``device`` (the card in a run: the host
             takes seconds an instance at 1.28M edges), so an instance
             depends on the seed and on the kind of device.
  ``torus``  a rows × cols two-dimensional torus, vertices numbered row by
             row, each vertex joined to its right and lower neighbour
             (wrapping): 2·rows·cols edges.
Weights: ``unit`` (all 1) or ``pm1`` (±1 at equal odds, drawn after the
edges). Edges come as (u, v) with u < v, sorted.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(seed: int, *path: int) -> np.random.Generator:
    """A generator for one draw of a run: the run's seed (any integer) and
    a path of small non-negative integers naming the draw."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *path]))


def n_vertices(traffic: dict) -> int:
    if traffic["family"] == "er":
        return int(traffic["n"])
    if traffic["family"] == "torus":
        return int(traffic["rows"]) * int(traffic["cols"])
    raise ValueError(f"unknown graph family {traffic['family']!r}")


def _er_edges(rng, n: int, p: float, device) -> np.ndarray:
    m = int(rng.binomial(n * (n - 1) // 2, p))
    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(1 << 62)))
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < m:
        draw = int((m - keys.numel()) * 1.05) + 64
        a = torch.randint(0, n, (draw,), generator=g, device=device)
        b = torch.randint(0, n, (draw,), generator=g, device=device)
        keep = a != b
        pairs = torch.minimum(a, b)[keep] * n + torch.maximum(a, b)[keep]
        keys = torch.unique(torch.cat([keys, pairs]))  # sorted
    if keys.numel() > m:
        pick = torch.randperm(keys.numel(), generator=g, device=device)[:m]
        keys = torch.sort(keys[pick]).values
    return torch.stack([keys // n, keys % n], 1).to(torch.int32).cpu().numpy()


def _torus_edges(rows: int, cols: int) -> np.ndarray:
    v = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    right = np.stack([v, np.roll(v, -1, axis=1)], axis=-1).reshape(-1, 2)
    down = np.stack([v, np.roll(v, -1, axis=0)], axis=-1).reshape(-1, 2)
    e = np.concatenate([right, down])
    e = np.sort(e, axis=1)
    e = e[np.lexsort((e[:, 1], e[:, 0]))]
    return e.astype(np.int32)


def instance(traffic: dict, seed: int, index: int, device="cpu"):
    """(n, edges (m, 2) int32, weights (m,) float32) of instance ``index``
    of the run seeded ``seed``; index −1 is the warm-up instance."""
    rng = rng_for(seed, 1, index + 1)
    n = n_vertices(traffic)
    if traffic["family"] == "er":
        edges = _er_edges(rng, n, float(traffic["p"]), device)
    else:
        edges = _torus_edges(int(traffic["rows"]), int(traffic["cols"]))
    if traffic["weights"] == "unit":
        weights = np.ones(edges.shape[0], dtype=np.float32)
    elif traffic["weights"] == "pm1":
        weights = rng.choice(np.array([-1.0, 1.0], dtype=np.float32),
                             size=edges.shape[0])
    else:
        raise ValueError(f"unknown weights {traffic['weights']!r}")
    return n, edges, weights
