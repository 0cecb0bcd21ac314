"""Exact Max-Cut and exact diagonal-cost objectives by exhaustive
enumeration (port of ``repro/core/baselines/brute_force.py``): the oracle
the solver's tests bound it with.

Each chunk of 2^chunk_qubits assignments is enumerated as the reference
does it: the bits of a basis index, an XOR per edge, and a product with
the weights (`torch.matmul`). It does not go through the port's `cutvals`
kernel: an oracle that shares the code under test would check nothing.
Across chunks a strictly larger value wins, so the earliest maximum is
kept, and the final index is widened to int64 before its bits are read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.graph import Graph, Problem, as_problem
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device


def brute_force_maxcut(graph: Graph, chunk_qubits: int = 22,
                       device: str | torch.device = "cuda"):
    """Returns (assignment (n,) int8, cut value float, SolveReport).

    Vertex 0 is fixed to 0 (a cut and its complement are equal), so
    2^(n-1) assignments are enumerated; n ≤ 30.
    """
    n = graph.n
    if n > 30:
        raise ValueError(f"brute force infeasible for n={n}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    best_val = -1.0
    best_idx = 0
    total = 1 << (n - 1)
    step = 1 << min(chunk_qubits, n - 1)
    edges = graph.edges.to(dev)
    weights = graph.weights.to(dev)
    for start in range(0, total, step):
        m = min(step, total - start)
        idx = torch.arange(start, start + m, dtype=torch.int32, device=dev) << 1
        s0 = (idx[:, None] >> edges[None, :, 0]) & 1
        s1 = (idx[:, None] >> edges[None, :, 1]) & 1
        cuts = (s0 ^ s1).to(torch.float32) @ weights
        j = int(torch.argmax(cuts))
        v = float(cuts[j])
        if v > best_val:
            best_val = v
            best_idx = start + j
    bits = ((np.int64(best_idx) << 1) >> np.arange(n)) & 1
    t1 = time.perf_counter()
    report = SolveReport(method="brute_force", n_vertices=n, cut_value=best_val,
                         runtime_s=t1 - t0)
    return bits.astype(np.int8), best_val, report


def brute_force_problem(problem: Graph | Problem, chunk_qubits: int = 22,
                        device: str | torch.device = "cuda"):
    """Exact maximizer of a `Problem`'s full objective (quadratic + linear +
    offset) over all 2^n assignments, n ≤ 26: a linear term breaks the
    flip symmetry `brute_force_maxcut` relies on. Returns (assignment (n,)
    int8, objective float, SolveReport)."""
    prob = as_problem(problem)
    graph = prob.graph
    n = graph.n
    if n > 26:
        raise ValueError(f"brute force infeasible for n={n}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    edges = graph.edges.to(dev)
    weights = graph.weights.to(dev)
    lin = prob.linear.to(device=dev, dtype=torch.float32)
    best_val = -np.inf
    best_idx = 0
    total = 1 << n
    step = 1 << min(chunk_qubits, n)
    vbits = torch.arange(n, dtype=torch.int32, device=dev)
    for start in range(0, total, step):
        m = min(step, total - start)
        idx = torch.arange(start, start + m, dtype=torch.int32, device=dev)
        s0 = (idx[:, None] >> edges[None, :, 0]) & 1
        s1 = (idx[:, None] >> edges[None, :, 1]) & 1
        vals = (s0 ^ s1).to(torch.float32) @ weights
        xbits = ((idx[:, None] >> vbits[None, :]) & 1).to(torch.float32)
        vals = vals + xbits @ lin
        j = int(torch.argmax(vals))
        v = float(vals[j])
        if v > best_val:
            best_val = v
            best_idx = start + j
    bits = (np.int64(best_idx) >> np.arange(n)) & 1
    best_val += float(prob.offset)
    t1 = time.perf_counter()
    report = SolveReport(method="brute_force", n_vertices=n, cut_value=best_val,
                         runtime_s=t1 - t0)
    return bits.astype(np.int8), best_val, report
