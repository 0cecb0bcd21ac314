"""The paper's connectivity-preserving partition (Alg. 1), written from its
definition: M = ceil(|V| / (N − 1)) contiguous vertex ranges, adjacent
ranges sharing one vertex, the fresh vertices spread so that range sizes
differ by at most one, each range at most N vertices. An edge lies inside
a range when both ends do; every other edge is a cross edge, scored by the
merge.
"""

from __future__ import annotations

import numpy as np


def n_ranges(n: int, n_qubits: int) -> int:
    """M: the fewest ranges of at most ``n_qubits`` vertices each."""
    if n <= n_qubits:
        return 1
    m = -(-n // (n_qubits - 1))
    while max(hi - lo for lo, hi in ranges(n, m)) > n_qubits:
        m += 1
    return m


def ranges(n: int, m: int) -> list[tuple[int, int]]:
    """(lo, hi) of each range: range i holds its fresh vertices and, after
    the first, the last vertex of range i − 1."""
    if m == 1:
        return [(0, n)]
    q, r = divmod(n, m)
    out, end = [], 0
    for i in range(m):
        fresh = q + (1 if i < r else 0)
        lo = end - 1 if i else 0
        end += fresh
        out.append((lo, end))
    return out


def split_edges(edges: np.ndarray, rngs: list[tuple[int, int]]):
    """For each edge, the range it lies inside, or −1 for a cross edge.

    Edges are (u, v) with u < v. Ranges overlap in one vertex only, so an
    edge lies inside at most one: the range that holds v and starts at or
    below u."""
    lo = np.asarray([a for a, _ in rngs], dtype=np.int64)
    hi = np.asarray([b for _, b in rngs], dtype=np.int64)
    u = edges[:, 0].astype(np.int64)
    v = edges[:, 1].astype(np.int64)
    # the first range whose end lies past v holds v; one further range may
    # also hold v when v is its shared vertex, and then it starts at v > u
    first = np.searchsorted(hi, v, side="right")
    first = np.minimum(first, len(rngs) - 1)
    inside = (lo[first] <= u) & (v < hi[first])
    return np.where(inside, first, -1)
