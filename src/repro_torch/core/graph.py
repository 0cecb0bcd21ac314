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


def independent_set_violations(graph: Graph, assignment) -> int:
    """Number of (unpadded) edges with both endpoints selected."""
    e = np.asarray(graph.edges)[: graph.n_edges]
    x = np.asarray(assignment).astype(np.int64)
    return int(np.sum(x[e[:, 0]] * x[e[:, 1]]))
