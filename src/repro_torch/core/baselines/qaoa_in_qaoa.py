"""QAOA-in-QAOA (QAOA², Zhou et al. 2023) baseline (port of
``repro/core/baselines/qaoa_in_qaoa.py``).

Partition the graph, QAOA-solve each subgraph, then decide each
subgraph's orientation (keep or flip) by a Max-Cut on the contracted graph
whose M supernodes are the subgraphs: an inter-edge (u, v) between
subgraphs a and b crosses the global cut iff s_u ⊕ s_v ⊕ z_a ⊕ z_b = 1, so
the contracted edge weighs w_diff − w_same, which may be negative. The
contraction recurses until it fits one solver. Every QAOA solve is the
port's batched one (`core.qaoa.solve_subgraph_batch`), on ``device``.

The reference QAOA² enumerates subproblem combinations on the host (hours
at 400 vertices in the paper); this solves the same contracted problem on
the device, so its times are conservative, and its cut math is the same.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.graph import Graph, cut_value
from repro_torch.core.partition import connectivity_preserving_partition
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device


def _top1(subgraphs, n_qubits: int, cfg, device) -> np.ndarray:
    """The top-1 basis index of each subgraph's QAOA solve, (M,) int64."""
    edges, weights, masks = qaoa_mod.pad_subgraph_arrays(subgraphs, n_qubits,
                                                         device=device)
    res = qaoa_mod.solve_subgraph_batch(edges, weights, masks, cfg)
    return res.bitstrings[:, 0].cpu().numpy().astype(np.int64)


def _solve_orientation(contracted: Graph, n_qubits: int, cfg, device) -> np.ndarray:
    """Max-Cut on the (possibly signed) contracted graph."""
    m = contracted.n
    if m == 1:
        return np.zeros(1, dtype=np.int8)
    if m <= n_qubits:
        idx = int(_top1([contracted], n_qubits, cfg, device)[0])
        return ((idx >> np.arange(m)) & 1).astype(np.int8)
    return _recurse(contracted, n_qubits, cfg, device)


def _contract(graph: Graph, ranges, local_bits) -> tuple[Graph, np.ndarray]:
    """Build the signed contracted graph from per-subgraph solutions."""
    m = len(ranges)
    n = graph.n
    owner = np.zeros(n, dtype=np.int32)
    sbits = np.zeros(n, dtype=np.int8)
    for a, ((lo, hi), bits) in enumerate(zip(ranges, local_bits)):
        owner[lo:hi] = a
        sbits[lo:hi] = bits[: hi - lo]

    e = np.asarray(graph.edges)[: graph.n_edges]
    w = np.asarray(graph.weights)[: graph.n_edges]
    oa, ob = owner[e[:, 0]], owner[e[:, 1]]
    inter = oa != ob
    su, sv = sbits[e[:, 0]], sbits[e[:, 1]]
    # signed weight: +w if crossing when z_a != z_b (s_u == s_v), else -w
    sign = np.where((su ^ sv)[inter] == 0, 1.0, -1.0)
    wmat = np.zeros((m, m), dtype=np.float64)
    a_, b_ = oa[inter], ob[inter]
    np.add.at(wmat, (a_, b_), sign * w[inter])
    np.add.at(wmat, (b_, a_), sign * w[inter])
    iu, ju = np.triu_indices(m, k=1)
    nz = wmat[iu, ju] != 0
    contracted = Graph.from_edges(
        m, np.stack([iu[nz], ju[nz]], 1), wmat[iu, ju][nz].astype(np.float32))
    return contracted, sbits


def _recurse(graph: Graph, n_qubits: int, cfg, device) -> np.ndarray:
    m_parts = int(np.ceil(graph.n / (n_qubits - 1)))
    part = connectivity_preserving_partition(graph, m_parts)
    idx = _top1(part.subgraphs, n_qubits, cfg, device)
    local_bits = [((int(idx[i]) >> np.arange(part.sizes[i])) & 1).astype(np.int8)
                  for i in range(part.m)]
    contracted, sbits = _contract(graph, part.ranges, local_bits)
    z = _solve_orientation(contracted, n_qubits, cfg, device)
    owner = np.zeros(graph.n, dtype=np.int32)
    for a, (lo, hi) in enumerate(part.ranges):
        owner[lo:hi] = a
    return (sbits ^ z[owner]).astype(np.int8)


def qaoa_in_qaoa(graph: Graph, n_qubits: int = 14, p_layers: int = 3,
                 opt_steps: int = 30, top_k: int = 1,
                 device: str | torch.device = "cuda"):
    """Returns (assignment (n,) int8, cut value float, SolveReport)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg = qaoa_mod.QAOAConfig(n_qubits=n_qubits, p_layers=p_layers,
                              opt_steps=opt_steps, top_k=max(top_k, 1))
    if graph.n <= n_qubits:
        idx = int(_top1([graph], n_qubits, cfg, dev)[0])
        assignment = ((idx >> np.arange(graph.n)) & 1).astype(np.int8)
    else:
        assignment = _recurse(graph, n_qubits, cfg, dev)
    val = float(cut_value(graph, torch.as_tensor(assignment)))
    t1 = time.perf_counter()
    report = SolveReport(method="qaoa_in_qaoa", n_vertices=graph.n, cut_value=val,
                         runtime_s=t1 - t0)
    return assignment, val, report
