"""Graphs and diagonal-cost problems (port of ``repro/core/graph.py``).

Graphs are padded edge lists held on the host: ``edges`` (E_pad, 2) int32
and ``weights`` (E_pad,) float32 CPU tensors, padding rows (0, 0) with
weight 0. The generators draw from numpy with the same calls in the same
order as the JAX package, so one seed gives equal graphs element for
element in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded, undirected, weighted graph.

    Attributes:
      n: number of vertices.
      edges: (E_pad, 2) int32 vertex indices, padding rows are (0, 0).
      weights: (E_pad,) float32, zero on padding rows.
      n_edges: true (unpadded) edge count.
    """

    n: int
    edges: torch.Tensor
    weights: torch.Tensor
    n_edges: int

    @classmethod
    def from_edges(
        cls,
        n: int,
        edge_list: Iterable[tuple[int, int]],
        weights: Sequence[float] | None = None,
        pad_to: int | None = None,
    ) -> "Graph":
        edge_arr = np.asarray(list(edge_list), dtype=np.int32).reshape(-1, 2)
        m = edge_arr.shape[0]
        w = (np.ones((m,), dtype=np.float32) if weights is None
             else np.asarray(weights, dtype=np.float32))
        if pad_to is None:
            pad_to = m
        if pad_to < m:
            raise ValueError(f"pad_to={pad_to} < n_edges={m}")
        ep = np.zeros((pad_to, 2), dtype=np.int32)
        wp = np.zeros((pad_to,), dtype=np.float32)
        ep[:m] = edge_arr
        wp[:m] = w
        return cls(n=n, edges=torch.from_numpy(ep),
                   weights=torch.from_numpy(wp), n_edges=m)

    @staticmethod
    def _er_edges(rng, n: int, p: float) -> np.ndarray:
        iu, ju = np.triu_indices(n, k=1)
        mask = rng.random(iu.shape[0]) < p
        return np.stack([iu[mask], ju[mask]], axis=1).astype(np.int32)

    @classmethod
    def erdos_renyi(cls, n: int, p: float, seed: int,
                    pad_to: int | None = None) -> "Graph":
        """Erdős–Rényi G(n, p), the paper's instance generator."""
        rng = np.random.default_rng(seed)
        return cls.from_edges(n, cls._er_edges(rng, n, p), pad_to=pad_to)

    @classmethod
    def erdos_renyi_weighted(cls, n: int, p: float, seed: int,
                             pad_to: int | None = None, low: float = 0.1,
                             high: float = 1.0) -> "Graph":
        """G(n, p) with weights uniform in [low, high): the topology of
        :meth:`erdos_renyi` for the same seed (weights drawn after it)."""
        rng = np.random.default_rng(seed)
        edge_arr = cls._er_edges(rng, n, p)
        w = rng.uniform(low, high, size=edge_arr.shape[0]).astype(np.float32)
        return cls.from_edges(n, edge_arr, w, pad_to=pad_to)

    @classmethod
    def spin_glass(cls, n: int, p: float, seed: int,
                   pad_to: int | None = None) -> "Graph":
        """G(n, p) topology with ±1 couplings (Edwards–Anderson spin glass)."""
        rng = np.random.default_rng(seed)
        edge_arr = cls._er_edges(rng, n, p)
        w = rng.choice(np.asarray([-1.0, 1.0], dtype=np.float32),
                       size=edge_arr.shape[0])
        return cls.from_edges(n, edge_arr, w.astype(np.float32), pad_to=pad_to)

    def total_weight(self) -> torch.Tensor:
        return torch.sum(self.weights)

    def degree(self) -> torch.Tensor:
        """(n,) float32 weighted degree: each vertex's incident weights
        summed along its `incidence` row (a fixed order)."""
        return incidence(self).weight.sum(dim=1)

    def dense_adjacency(self, device="cpu") -> torch.Tensor:
        """(n, n) float32 symmetric adjacency on ``device``; padding rows
        add weight 0 at (0, 0). Dense: n^2 floats (1 GB at n = 16,000)."""
        i = self.edges[:, 0].long().to(device)
        j = self.edges[:, 1].long().to(device)
        w = self.weights.to(device)
        a = torch.zeros((self.n, self.n), dtype=torch.float32, device=device)
        a.index_put_((i, j), w, accumulate=True)
        a.index_put_((j, i), w, accumulate=True)
        return a


@dataclasses.dataclass(frozen=True)
class Problem:
    """A diagonal-cost objective over ``n`` binary variables.

    The solver maximizes
    ``sum_{(u,v)} w_uv * (x_u XOR x_v) + sum_v h_v * x_v + offset``.
    Max-Cut is ``h = 0, offset = 0``; QUBOs and penalty-encoded MIS map onto
    the same form via ``x_u * x_v = (x_u + x_v - (x_u XOR x_v)) / 2``. The
    kernels and the merge score the internal objective (quadratic +
    linear); ``offset`` is added only when reporting (`problem_value`).
    """

    graph: Graph
    linear: torch.Tensor  # (n,) float32
    offset: float
    kind: str  # "maxcut" | "qubo" | "mis"

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def has_linear(self) -> bool:
        return bool(torch.any(self.linear != 0))

    @classmethod
    def maxcut(cls, graph: Graph) -> "Problem":
        return cls(graph=graph, linear=torch.zeros(graph.n, dtype=torch.float32),
                   offset=0.0, kind="maxcut")

    @classmethod
    def qubo(
        cls,
        n: int,
        quad_edges: Iterable[tuple[int, int]],
        quad_coeffs: Sequence[float],
        linear: Sequence[float] | None = None,
        offset: float = 0.0,
        pad_to: int | None = None,
    ) -> "Problem":
        """Maximize ``sum_{i<j} Q_ij x_i x_j + sum_i h_i x_i + offset``:
        each ``Q_ij`` becomes XOR weight ``-Q_ij / 2`` plus ``+Q_ij / 2`` on
        the linear term of both endpoints (folded in float64)."""
        e = np.asarray(list(quad_edges), dtype=np.int32).reshape(-1, 2)
        q = np.asarray(quad_coeffs, dtype=np.float64).reshape(-1)
        if e.shape[0] != q.shape[0]:
            raise ValueError(f"{e.shape[0]} quad edges but {q.shape[0]} coefficients")
        h = np.zeros((n,), dtype=np.float64)
        if linear is not None:
            h += np.asarray(linear, dtype=np.float64)
        np.add.at(h, e[:, 0], q / 2.0)
        np.add.at(h, e[:, 1], q / 2.0)
        g = Graph.from_edges(n, e, (-q / 2.0).astype(np.float32), pad_to=pad_to)
        return cls(graph=g, linear=torch.from_numpy(h.astype(np.float32)),
                   offset=float(offset), kind="qubo")

    @classmethod
    def mis(cls, graph: Graph, penalty: float = 2.0) -> "Problem":
        """Maximum independent set via the penalty QUBO
        ``sum_i x_i - P * sum_{(i,j) in E} x_i x_j``, P >= 2 (edge weights
        of ``graph`` are ignored: it is a conflict graph)."""
        if penalty < 2.0:
            raise ValueError(f"penalty={penalty} < 2 does not guarantee independence")
        e = np.asarray(graph.edges)[: graph.n_edges]
        q = np.full((graph.n_edges,), -float(penalty))
        p = cls.qubo(graph.n, e, q, linear=np.ones((graph.n,)),
                     pad_to=graph.edges.shape[0])
        return dataclasses.replace(p, kind="mis")


def as_problem(obj: Graph | Problem) -> Problem:
    """A `Graph` is Max-Cut; a `Problem` passes through."""
    return obj if isinstance(obj, Problem) else Problem.maxcut(obj)


def cut_value(graph: Graph, assignment: torch.Tensor) -> torch.Tensor:
    """Cut value of one 0/1 assignment vector of shape (n,)."""
    s = torch.as_tensor(assignment).to(torch.int32)
    e = graph.edges.long()
    crossed = s[e[:, 0]] ^ s[e[:, 1]]
    return torch.sum(graph.weights * crossed.to(graph.weights.dtype))


def cut_value_batch(graph: Graph, assignments: torch.Tensor) -> torch.Tensor:
    """Cut values of a batch of 0/1 assignments, (B, n) → (B,), on the
    assignments' device. Integer weights give exact integers."""
    s = torch.as_tensor(assignments).to(torch.int32)
    e = graph.edges.long().to(s.device)
    crossed = s[:, e[:, 0]] ^ s[:, e[:, 1]]
    w = graph.weights.to(s.device)
    return crossed.to(w.dtype) @ w


def problem_value(problem: Problem, assignment: torch.Tensor) -> torch.Tensor:
    """Full objective (quadratic + linear + offset) of one 0/1 assignment."""
    x = torch.as_tensor(assignment).to(problem.linear.dtype)
    return cut_value(problem.graph, assignment) + problem.linear @ x + problem.offset


def problem_value_batch(problem: Problem, assignments: torch.Tensor) -> torch.Tensor:
    """Full objective for a batch of 0/1 assignments, (B, n) → (B,)."""
    a = torch.as_tensor(assignments)
    x = a.to(problem.linear.dtype)
    return (cut_value_batch(problem.graph, a) + x @ problem.linear.to(a.device)
            + problem.offset)


@dataclasses.dataclass(frozen=True)
class Incidence:
    """Every vertex's incident edges as a padded (n, D) table, D the largest
    degree (at least 1).

    ``nbr[v, j]`` is the other end of v's j-th edge and ``weight[v, j]`` its
    weight; padding slots hold vertex 0 and weight 0. A vertex's slots list
    the edges it is the first end of, in edge order, then those it is the
    second end of: the order of the reference's two scatter-adds. A sum
    along the slot axis adds in that fixed order on every device, where a
    scatter-add (``index_add_``) on CUDA adds in atomic order.
    """

    nbr: torch.Tensor  # (n, D) int64
    weight: torch.Tensor  # (n, D) float32


def incidence(graph: Graph, device="cpu") -> Incidence:
    """The `Incidence` table of ``graph``'s real edges, built on the host
    and placed on ``device``. A vertex of degree d holds d real slots, so
    the table is n·D entries, D the largest degree."""
    e = np.asarray(graph.edges)[: graph.n_edges].astype(np.int64)
    w = np.asarray(graph.weights)[: graph.n_edges]
    owner = np.concatenate([e[:, 0], e[:, 1]])
    other = np.concatenate([e[:, 1], e[:, 0]])
    ww = np.concatenate([w, w])
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=graph.n)
    width = max(int(counts.max(initial=0)), 1)
    starts = np.cumsum(counts) - counts
    rows = owner[order]
    slots = np.arange(rows.size) - starts[rows]
    nbr = np.zeros((graph.n, width), dtype=np.int64)
    wt = np.zeros((graph.n, width), dtype=np.float32)
    nbr[rows, slots] = other[order]
    wt[rows, slots] = ww[order]
    return Incidence(nbr=torch.as_tensor(nbr, device=device),
                     weight=torch.as_tensor(wt, device=device))


def subgraph(graph: Graph, lo: int, hi: int, pad_to: int | None = None) -> Graph:
    """Induced subgraph on the contiguous vertex range [lo, hi), relabelled
    to [0, hi - lo). Host-side numpy, as partitioning is."""
    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights)[: graph.n_edges]
    m = (e[:, 0] >= lo) & (e[:, 0] < hi) & (e[:, 1] >= lo) & (e[:, 1] < hi)
    return Graph.from_edges(hi - lo, e[m] - lo, w[m], pad_to=pad_to)


def networkx_to_graph(nx_graph, pad_to: int | None = None) -> Graph:
    """Convert a networkx graph (integer-labelled 0..n-1) to a `Graph`; an
    edge without a ``weight`` attribute weighs 1."""
    n = nx_graph.number_of_nodes()
    edges, weights = [], []
    for u, v, data in nx_graph.edges(data=True):
        edges.append((u, v))
        weights.append(float(data.get("weight", 1.0)))
    return Graph.from_edges(n, edges, weights, pad_to=pad_to)


def independent_set_violations(graph: Graph, assignment) -> int:
    """Number of (unpadded) edges with both endpoints selected."""
    e = np.asarray(graph.edges)[: graph.n_edges]
    x = np.asarray(assignment).astype(np.int64)
    return int(np.sum(x[e[:, 0]] * x[e[:, 1]]))
