"""End-to-end ParaQAOA on one GPU: partition → batched QAOA → level-aware
merge → report (port of ``repro/core/paraqaoa.py``, the paper's Fig. 3).

Parameter taxonomy (paper §4.2):
  hardware-dependent: n_solvers (N_s), n_qubits (N)
  input-dependent:    m_subgraphs (M = ceil(|V|/(N-1))), rounds (T = ceil(M/N_s))
  tunable:            top_k (K), merge_level (L) / beam_width
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.baselines.local_search import refine
from repro_torch.core.graph import Graph, Problem, as_problem, problem_value
from repro_torch.core.partition import Partition, partition_for_solver, split_linear
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device
from repro_torch.obs import trace as trace_mod


@dataclasses.dataclass(frozen=True)
class ParaQAOAConfig:
    # hardware-dependent (paper: N_s solvers × N qubits)
    n_qubits: int = 14  # N — per-solver qubit budget (26 on the paper's GPUs)
    n_solvers: int = 1  # N_s — concurrent solver instances (mesh data-axis size)
    # tunable (paper: K, L)
    top_k: int = 2  # K — candidates kept per subgraph
    merge_level: int = 2  # L — frontier materialization level (distributed merge)
    beam_width: Optional[int] = None  # None → exact 2·K^M (capped)
    beam_cap: int = 1 << 18
    # QAOA solver knobs
    p_layers: int = 3
    opt_steps: int = 30
    learning_rate: float = 0.05
    ramp_delta: float = 0.75
    # Adam steps on oversized subproblems, through the sharded evolution of
    # `distributed.solve_distributed`; 0 keeps the linear ramp. The
    # single-device `solve` has no oversized subproblems and never reads it
    sharded_opt_steps: int = 0
    # beyond-paper: 1-flip local-search steps on the merged assignment
    # (`baselines.local_search.refine`); 0 skips the refinement
    refine_steps: int = 0

    def qaoa_config(self) -> qaoa_mod.QAOAConfig:
        return qaoa_mod.QAOAConfig(
            n_qubits=self.n_qubits,
            p_layers=self.p_layers,
            opt_steps=self.opt_steps,
            learning_rate=self.learning_rate,
            ramp_delta=self.ramp_delta,
            top_k=self.top_k,
        )


@dataclasses.dataclass
class ParaQAOAOutput:
    assignment: np.ndarray
    cut_value: float
    partition: Partition
    report: SolveReport
    timings: dict
    candidates: np.ndarray  # (M, K) basis indices from the QAOA stage


def merge_inputs(part: Partition, bit_indices: np.ndarray, cfg: ParaQAOAConfig,
                 linear=None, device="cpu") -> tuple[merge_mod.MergePlan, int]:
    """Stage-3 (plan, beam width): the beam and cap rules in one place."""
    plan = merge_mod.build_merge_plan(part, bit_indices, cfg.top_k,
                                      linear=linear, device=device)
    bw = cfg.beam_width or merge_mod.exact_beam_width(cfg.top_k, part.m,
                                                      cap=cfg.beam_cap)
    return plan, bw


def merge_candidates(part: Partition, bit_indices: np.ndarray,
                     cfg: ParaQAOAConfig, linear=None,
                     device="cpu") -> tuple[np.ndarray, float, int]:
    """Stage-3 merge of solved candidates → (assignment, score, beam width).

    The score is the internal (offset-free) objective: cut + linear terms.
    """
    plan, bw = merge_inputs(part, bit_indices, cfg, linear=linear,
                            device=device)
    merged = merge_mod.merge_scan(plan, bw)
    return (merged.assignment.cpu().numpy(), float(merged.cut_value), bw)


def refine_merged(graph: Graph, assignment: np.ndarray, cut: float,
                  cfg: ParaQAOAConfig, linear, device):
    """The refine stage: ``cfg.refine_steps`` 1-flip steps on the merged
    assignment (with the internal objective's linear terms), or the merge's
    result as it is at 0 steps. Returns (assignment, internal score)."""
    if cfg.refine_steps == 0:
        return assignment, cut
    return refine(graph, assignment, cfg.refine_steps, linear=linear,
                  device=device)


def checked_value(prob: Problem, assignment: np.ndarray, cut: float,
                  cfg: ParaQAOAConfig) -> float:
    """The reported value: the full objective re-scored from scratch. Without
    refinement the merge's incremental score must equal it on the internal
    (offset-free) part; the refinement's own score is re-scored already."""
    obj = float(problem_value(prob, torch.as_tensor(assignment)))
    internal = obj - prob.offset
    if cfg.refine_steps == 0:
        assert abs(internal - cut) < 1e-2 * max(1.0, abs(internal)), (internal, cut)
    return obj


def solve(graph: Graph | Problem, cfg: ParaQAOAConfig = ParaQAOAConfig(),
          partition: Partition | None = None,
          device: str | torch.device = "cuda") -> ParaQAOAOutput:
    """Solve one instance end to end on ``device`` (default the GPU; raises
    when it is missing).

    ``graph`` may be a `Graph` (Max-Cut) or a `Problem` (weighted Max-Cut,
    QUBO, MIS): linear terms thread through the cost oracle, the partition
    (each vertex's term to one subproblem) and the merge beam; the reported
    value is the full objective including the offset.
    """
    dev = resolve_device(device)
    prob = as_problem(graph)
    graph = prob.graph
    has_lin = prob.has_linear
    lin_host = prob.linear.numpy() if has_lin else None
    tr = trace_mod.get_tracer()
    with tr.span("solve", n=graph.n, n_edges=graph.n_edges) as root:
        # ---- stage 1: graph partition (paper Alg. 1) ---------------------
        with tr.span("partition", n_qubits=cfg.n_qubits) as sp_part:
            part = partition or partition_for_solver(graph, cfg.n_qubits)
            sub_lins = split_linear(part, lin_host) if has_lin else None

        # ---- stage 2: every subgraph's QAOA in one batch ------------------
        with tr.span("solve_pool", m=part.m, n_qubits=cfg.n_qubits) as sp_solve:
            qcfg = cfg.qaoa_config()
            edges, weights, masks = qaoa_mod.pad_subgraph_arrays(
                part.subgraphs, qcfg.n_qubits, device=dev)
            linears = (qaoa_mod.pad_linear_arrays(sub_lins, qcfg.n_qubits,
                                                  device=dev)
                       if has_lin else None)
            result = qaoa_mod.solve_subgraph_batch(edges, weights, masks, qcfg,
                                                   linear=linears)
            bit_indices = result.bitstrings.cpu().numpy()  # (M, K); syncs

        # ---- stage 3: level-aware merge ----------------------------------
        with tr.span("merge", m=part.m) as sp_merge:
            assignment, cut, bw = merge_candidates(part, bit_indices, cfg,
                                                   linear=lin_host, device=dev)

        # ---- optional beyond-paper refinement ----------------------------
        with tr.span("refine", steps=cfg.refine_steps) as sp_refine:
            assignment, cut = refine_merged(part.graph, assignment, cut, cfg,
                                            lin_host, dev)

    obj = checked_value(prob, assignment, cut, cfg)
    timings = {
        "partition_s": sp_part.duration_s,
        "solve_s": sp_solve.duration_s,
        "merge_s": sp_merge.duration_s,
        "refine_s": sp_refine.duration_s,
        "total_s": root.duration_s,
    }
    report = SolveReport(
        method="paraqaoa",
        n_vertices=graph.n,
        cut_value=obj,
        runtime_s=timings["total_s"],
        extra={"m_subgraphs": part.m, "k": cfg.top_k, "beam": bw, **timings},
    )
    return ParaQAOAOutput(assignment=assignment, cut_value=obj, partition=part,
                          report=report, timings=timings,
                          candidates=bit_indices)
