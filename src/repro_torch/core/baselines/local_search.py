"""Vectorized 1-flip local search (port of
``repro/core/baselines/local_search.py``).

Used two ways: as a classical baseline (`local_search`, random restarts),
and as the beyond-paper refinement of ParaQAOA's merged assignment
(`refine`). The flip gain of vertex v is g(v) = deg_w(v) − 2·cut_incident(v)
(+ h_v·(1 − 2·s_v) with linear terms), for all vertices at once.

The gains sum each vertex's incident weights along its row of the
`graph.Incidence` table, built once a call: a fixed order on every device,
so a card run repeats bit for bit, where a scatter-add on CUDA adds in
atomic order and `argmax` could pick another vertex on a near-tie. The
weighted degree does not depend on the assignment and is summed once.
Every step stays on the device (no host read inside the loop), and every
step runs: the loop does not stop early.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.graph import Graph, Incidence, cut_value, incidence
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device


def _sweeps(table: Incidence, weights, linear, assignment, steps: int):
    """``steps`` best-improvement flips of the (n,) int32 ``assignment``.

    ``table`` is the graph's incidence on the assignment's device,
    ``weights`` its (E,) edge weights and ``linear`` (n,) f32 there too.
    Each step flips the first vertex of largest gain when that gain exceeds
    1e-6·(Σ|w| + Σ|h|): a threshold relative to the objective's scale (an
    absolute one rejected every real improvement on graphs of tiny weights
    and accepted float noise on huge ones).
    """
    eps = 1e-6 * (torch.sum(torch.abs(weights)) + torch.sum(torch.abs(linear)))
    nbr, w = table.nbr, table.weight
    deg = torch.sum(w, dim=1)
    verts = torch.arange(assignment.shape[0], device=assignment.device)
    s = assignment
    for _ in range(steps):
        crossed = (s[:, None] ^ s[nbr]).to(w.dtype)
        quad = deg - 2.0 * torch.sum(w * crossed, dim=1)
        g = quad + linear * (1.0 - 2.0 * s.to(w.dtype))
        v = torch.argmax(g)  # the first maximum, as jnp.argmax
        s = torch.where((verts == v) & (g[v] > eps), 1 - s, s)
    return s


def _score(graph: Graph, s: np.ndarray, linear) -> float:
    """From-scratch objective of a final assignment, the linear term in
    float64. A running score carried through the steps drifts from the true
    value in f32 over hundreds of flips on weighted instances, so every
    caller re-scores the assignment instead."""
    val = float(cut_value(graph, torch.as_tensor(s)))
    if linear is not None:
        lin = np.asarray(linear, dtype=np.float64)
        val += float(lin @ np.asarray(s, dtype=np.float64))
    return val


def refine(graph: Graph, assignment: np.ndarray, steps: int, linear=None,
           device: str | torch.device = "cuda"):
    """Best-improvement 1-flip refinement of an assignment on ``device``.

    ``linear`` (n,) f32, optional, refines the full internal objective
    (quadratic cut + per-vertex linear terms) of a QUBO or MIS. Returns
    (assignment (n,) int8, objective float).
    """
    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(assignment), dtype=torch.int32, device=dev)
    lin = (torch.zeros((graph.n,), dtype=torch.float32, device=dev)
           if linear is None
           else torch.as_tensor(np.asarray(linear, dtype=np.float32), device=dev))
    s = _sweeps(incidence(graph, dev), graph.weights.to(dev), lin, s, steps)
    out = s.cpu().numpy().astype(np.int8)
    return out, _score(graph, out, linear)


def local_search(graph: Graph, restarts: int = 8, steps: int = 200,
                 seed: int = 0, device: str | torch.device = "cuda"):
    """Random-restart 1-flip local search baseline; the starts are the
    reference's ``default_rng(seed)`` draws. Returns (assignment, cut,
    SolveReport)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    table = incidence(graph, dev)
    weights = graph.weights.to(dev)
    zeros = torch.zeros((graph.n,), dtype=torch.float32, device=dev)
    best_s, best_v = None, -np.inf
    for _ in range(restarts):
        s0 = rng.integers(0, 2, size=graph.n).astype(np.int32)
        s = _sweeps(table, weights, zeros, torch.as_tensor(s0, device=dev), steps)
        s = s.cpu().numpy().astype(np.int8)
        v = _score(graph, s, None)
        if v > best_v:
            best_v, best_s = v, s
    t1 = time.perf_counter()
    report = SolveReport(method="local_search", n_vertices=graph.n,
                         cut_value=best_v, runtime_s=t1 - t0)
    return best_s, best_v, report
