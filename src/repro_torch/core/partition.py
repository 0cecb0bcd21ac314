"""Connectivity-Preserving Partitioning, paper Alg. 1 (port of
``repro/core/partition.py``).

Host-side numpy, as in the reference, so a partition here equals the JAX
package's element for element. Vertex indices split into M contiguous
ranges; adjacent ranges share exactly one vertex. Edges inside no
subgraph are recorded as inter-partition edges, which the merge scores.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class Partition:
    """A chain of subgraphs.

    Attributes:
      subgraphs: induced subgraphs with local vertex labels.
      ranges: (lo, hi) global vertex range per subgraph;
        ranges[i].hi - 1 == ranges[i+1].lo is the shared vertex.
      sizes: vertices per subgraph.
      inter_edges: (E_x, 2) int32 global edges inside no subgraph.
      inter_weights: (E_x,) float32.
      graph: the original graph.
    """

    subgraphs: List[Graph]
    ranges: List[tuple]
    sizes: List[int]
    inter_edges: np.ndarray
    inter_weights: np.ndarray
    graph: Graph

    @property
    def m(self) -> int:
        return len(self.subgraphs)


def alg1_ranges(n: int, m: int) -> List[tuple]:
    """Paper Alg. 1 verbatim: s = floor(|V|/M) - 1, range i covers
    [i*s, i*s + s + 1), the last range takes the remainder. It can
    overflow the last partition past ceil(|V|/M) (|V| = 400, M = 16 gives
    40 vertices), so `balanced_ranges` is the default; kept for fidelity
    experiments."""
    if m < 1:
        raise ValueError("need at least one partition")
    if m == 1:
        return [(0, n)]
    s = n // m - 1
    if s < 1:
        raise ValueError(f"partition size too small: |V|={n}, M={m}")
    ranges = []
    for i in range(1, m + 1):
        start = (i - 1) * s
        end = n if i == m else start + s + 1
        ranges.append((start, end))
    return ranges


def balanced_ranges(n: int, m: int) -> List[tuple]:
    """Alg. 1 with the remainder spread over the partitions: every range
    gets floor(n/m) or ceil(n/m) fresh vertices (+1 shared vertex after the
    first), so sizes differ by at most 1."""
    if m < 1:
        raise ValueError("need at least one partition")
    if m == 1:
        return [(0, n)]
    q, r = divmod(n, m)
    if q < 1 or (q == 1 and r == 0 and m > 1):
        raise ValueError(f"partition size too small: |V|={n}, M={m}")
    ranges = []
    pos = 0
    for i in range(m):
        fresh = q + (1 if i < r else 0)
        if i == 0:
            lo, hi = 0, fresh
        else:
            lo, hi = pos - 1, pos - 1 + fresh + 1
        ranges.append((lo, hi))
        pos = hi
    assert ranges[-1][1] == n, ranges
    return ranges


def _contiguous_ranges(n: int, m: int, exact_alg1: bool = False) -> List[tuple]:
    return alg1_ranges(n, m) if exact_alg1 else balanced_ranges(n, m)


def connectivity_preserving_partition(graph: Graph, m: int,
                                      pad_edges: bool = True) -> Partition:
    """Paper Alg. 1: contiguous ranges with one shared vertex per boundary."""
    return _build_partition(graph, _contiguous_ranges(graph.n, m), pad_edges)


def random_partition(graph: Graph, m: int, seed: int,
                     pad_edges: bool = True) -> Partition:
    """QAOA²-style randomized partition (a baseline): a random vertex order
    from ``seed``, then contiguous ranges over the shuffled labels. The
    relabelled graph is the partition's ``graph``, so the chain and
    shared-vertex contract of Alg. 1 holds and the merge is unchanged."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(graph.n).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(graph.n, dtype=np.int32)
    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights)[: graph.n_edges]
    relabelled = Graph.from_edges(graph.n, inv[e], w, pad_to=graph.edges.shape[0])
    return _build_partition(relabelled, _contiguous_ranges(graph.n, m), pad_edges)


def partition_for_solver(graph: Graph, max_qubits: int) -> Partition:
    """M = ceil(|V| / (N - 1)), raised until every subgraph fits N qubits."""
    if graph.n <= max_qubits:
        return connectivity_preserving_partition(graph, 1)
    m = int(np.ceil(graph.n / (max_qubits - 1)))
    while True:
        ranges = balanced_ranges(graph.n, m)
        if max(hi - lo for lo, hi in ranges) <= max_qubits:
            break
        m += 1
    part = connectivity_preserving_partition(graph, m)
    assert max(part.sizes) <= max_qubits, (
        f"partition produced subgraph of {max(part.sizes)} > N={max_qubits}")
    return part


def _build_partition(graph: Graph, ranges: List[tuple],
                     pad_edges: bool) -> Partition:
    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights)[: graph.n_edges]
    covered = np.zeros(e.shape[0], dtype=bool)
    sub_edge_lists = []
    sizes = []
    for lo, hi in ranges:
        inside = (e[:, 0] >= lo) & (e[:, 0] < hi) & (e[:, 1] >= lo) & (e[:, 1] < hi)
        covered |= inside
        sub_edge_lists.append((lo, hi, e[inside] - lo, w[inside]))
        sizes.append(hi - lo)
    pad = max(max((el.shape[0] for _, _, el, _ in sub_edge_lists), default=1), 1)
    if not pad_edges:
        pad = None
    subgraphs = [Graph.from_edges(hi - lo, el, wl, pad_to=pad)
                 for lo, hi, el, wl in sub_edge_lists]
    inter = ~covered
    return Partition(
        subgraphs=subgraphs,
        ranges=list(ranges),
        sizes=sizes,
        inter_edges=e[inter].astype(np.int32),
        inter_weights=w[inter].astype(np.float32),
        graph=graph,
    )


def split_linear(part: Partition, linear) -> List[np.ndarray]:
    """Give each vertex's linear term to its first covering range only
    (the first-coverage rule the merge plan uses), in local labels."""
    lin = np.asarray(linear, dtype=np.float32)
    assert lin.shape == (part.graph.n,), (lin.shape, part.graph.n)
    hi_arr = np.asarray([hi for _, hi in part.ranges], dtype=np.int64)
    level = np.searchsorted(hi_arr, np.arange(part.graph.n), side="right")
    level = np.clip(level, 0, part.m - 1)
    out: List[np.ndarray] = []
    for i, (lo, hi) in enumerate(part.ranges):
        li = np.zeros(hi - lo, dtype=np.float32)
        idx = np.nonzero(level == i)[0]
        li[idx - lo] = lin[idx]
        out.append(li)
    return out


def stitch_assignments(part: Partition, local_bits: List[np.ndarray]) -> np.ndarray:
    """Per-subgraph 0/1 assignments concatenated into one (n,) int8
    assignment. Adjacent subgraphs share a vertex; the caller orients each
    local bitstring so the shared vertex agrees, and the later subgraph's
    value stands on the overlap."""
    out = np.zeros(part.graph.n, dtype=np.int8)
    for (lo, hi), bits in zip(part.ranges, local_bits):
        out[lo:hi] = np.asarray(bits, dtype=np.int8)[: hi - lo]
    return out
