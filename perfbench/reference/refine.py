"""Best-improvement one-flip local search, written from its definition: at
each step flip the first vertex of largest gain, where the gain of v is
Σ over its edges of w·(1 if its ends agree else −1), when that gain exceeds
1e-6·Σ|w|; otherwise leave the assignment as it is. Gains are kept up to
date after each flip from the flipped vertex's edges alone.
"""

from __future__ import annotations

import numpy as np


def refine(n: int, edges: np.ndarray, weights: np.ndarray, assignment,
           steps: int) -> np.ndarray:
    x = np.asarray(assignment, dtype=np.int8).copy()
    if steps == 0:
        return x
    w = weights.astype(np.float64)
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    sign = np.where(x[u] == x[v], 1.0, -1.0)
    gain = np.bincount(u, w * sign, minlength=n) + np.bincount(v, w * sign, minlength=n)
    # each vertex's edges as (other end, weight), for the update after a flip
    ends = np.concatenate([u, v])
    order = np.argsort(ends, kind="stable")
    other = np.concatenate([v, u])[order]
    ww = np.concatenate([w, w])[order]
    start = np.searchsorted(ends[order], np.arange(n + 1))
    eps = 1e-6 * float(np.sum(np.abs(w)))
    for _ in range(steps):
        best = int(np.argmax(gain))
        if not gain[best] > eps:
            continue
        nb, nw = other[start[best]:start[best + 1]], ww[start[best]:start[best + 1]]
        agree_before = x[nb] == x[best]
        # the edge (best, u) flips between agreeing and not: u's gain moves
        # by −2w where the ends agreed and by +2w where they did not
        np.add.at(gain, nb, np.where(agree_before, -2.0, 2.0) * nw)
        gain[best] = -gain[best]
        x[best] ^= 1
    return x
