"""ParaQAOA with a `model` mesh axis: the sharded statevector (the port of
``repro/core/distributed.py:150-333`` and ``:400-678``, model axis only).

`sharded_qaoa` runs one n-qubit QAOA circuit with its 2^n amplitudes
sharded over the D shards of a `core.axis` axis: only the h = log2(D)
"global" qubits need mixing across shards, and one qubit swap a layer
rotates them into locality. That lifts the per-device qubit cap N to
N + h. `sharded_qaoa_batch` runs a batch of same-n subgraphs as rows,
as many per launch as the card holds. `solve_distributed` is the solve
with a mesh: partition at the lifted budget, subgraphs of N qubits or
fewer through the single-device batch, the larger ones grouped by n
through `sharded_qaoa_batch`, then the single-device merge.

The `data` (and `pod`) axes, `solve_pool`, `merge_sharded`,
`striped_beam_width` and `global_winner`, are not ported (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import paraqaoa as para_mod
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.axis import LocalAxis, ProcessGroupAxis
from repro_torch.core.graph import as_problem
from repro_torch.core.partition import partition_for_solver, split_linear
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.obs import trace as trace_mod

# device bytes per amplitude a subgraph holds at its peak: two cut views
# and three live state pairs without autograd; with it, each layer saves
# its output and its mixer's (16 B) on top of the backward's temporaries.
# Measured on an H100 at n = 26, D = 4 (chip_smoke.py phases 7 and 10):
# 44 B without autograd, 155 B with it at p = 3
FWD_BYTES_PER_AMP = 48
GRAD_BYTES_PER_LAYER, GRAD_BYTES_BASE = 16, 112
MEMORY_SHARE = 0.6  # of the card's memory a launch may plan to fill


class ShardedQAOAResult(NamedTuple):
    bitstrings: torch.Tensor  # (B, K) int32 global basis indices
    probs: torch.Tensor  # (B, K)
    expectation: torch.Tensor  # (B,)
    gammas: torch.Tensor  # (B, p) as run (optimized when opt_steps > 0)
    betas: torch.Tensor  # (B, p)


def subgraphs_per_launch(n: int, p: int, opt_steps: int, axis, device) -> int:
    """How many n-qubit subgraphs one launch of the sharded engine takes so
    that its peak stays within `MEMORY_SHARE` of the card; no cap on the
    CPU. Deterministic for a card, so a caller can predict the launches."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1 << 30
    per_amp = (GRAD_BYTES_BASE + GRAD_BYTES_PER_LAYER * p if opt_steps
               else FWD_BYTES_PER_AMP)
    amps = axis.local * 2 ** (n - axis.h)  # this process's share of one subgraph
    budget = MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory
    return max(1, int(budget // (per_amp * amps)))


def launch_slices(b: int, per_launch: int) -> list[slice]:
    """``b`` subgraphs in the fewest launches of at most ``per_launch``,
    as even as they go."""
    chunks = -(-b // per_launch)
    size = -(-b // chunks)
    return [slice(s, min(s + size, b)) for s in range(0, b, size)]


def sharded_qaoa_batch(edges, weights, n: int, gammas, betas, axis,
                       top_k: int = 4, schedule: str = "alternating",
                       group: int = 7, opt_steps: int = 0,
                       learning_rate: float = 0.05,
                       linears=None) -> ShardedQAOAResult:
    """`sharded_qaoa` over a batch of same-n subgraphs.

    ``edges`` (B, E, 2) / ``weights`` (B, E), padded with zero-weight
    rows; ``gammas``/``betas`` (p,) shared by the batch or (B, p); the
    run (or, with ``opt_steps`` > 0, the initial) angles. ``linears``
    (B, n) optional per-vertex terms. The subgraphs run as rows, as many
    per launch as `subgraphs_per_launch` allows.
    """
    b = edges.shape[0]
    if gammas.dim() == 1:
        gammas, betas = gammas.expand(b, -1), betas.expand(b, -1)
    layout = engine.ShardedLayout(n=n, axis=axis, schedule=schedule, group=group)
    if top_k > layout.local_dim:
        raise ValueError(f"top_k={top_k} exceeds the {layout.local_dim} amplitudes "
                         "of a shard")
    per_launch = subgraphs_per_launch(n, gammas.shape[1], opt_steps, axis,
                                      edges.device)
    outs = []
    for sl in launch_slices(b, per_launch):
        lin = None if linears is None else linears[sl]
        cut = engine.cut_table(layout, edges[sl], weights[sl], lin)
        gam, bet = gammas[sl].contiguous(), betas[sl].contiguous()
        if opt_steps:
            gam, bet = engine.sharded_ascent(layout, cut, gam, bet, opt_steps,
                                             learning_rate)
        with torch.no_grad():
            re, im, in_b = engine.evolve(layout, cut, gam, bet)
            exp = engine.expectation(layout, re, im, cut, in_b)
            bits, probs = engine.top_candidates(layout, re, im, cut, in_b, top_k)
        del re, im, cut  # free this launch's planes before the next one's
        outs.append(ShardedQAOAResult(bits, probs, exp, gam, bet))
    return ShardedQAOAResult(*(torch.cat(f) for f in zip(*outs)))


def sharded_qaoa(edges, weights, n: int, gammas, betas, axis, top_k: int = 4,
                 schedule: str = "alternating", group: int = 7,
                 opt_steps: int = 0, learning_rate: float = 0.05,
                 linear=None) -> ShardedQAOAResult:
    """One n-qubit QAOA circuit with its amplitudes sharded over ``axis``.

    edges (E, 2), weights (E,), angles (p,), ``linear`` (n,) optional.
    With ``opt_steps`` > 0 the sharded Adam ascent optimizes the angles
    through the swap schedule before the final evolution; 0 runs them as
    given. The result's fields drop the batch axis: bits and probs (K,),
    the expectation a scalar, the angles (p,).
    """
    res = sharded_qaoa_batch(
        edges[None], weights[None], n, gammas[None], betas[None], axis,
        top_k=top_k, schedule=schedule, group=group, opt_steps=opt_steps,
        learning_rate=learning_rate,
        linears=None if linear is None else linear[None])
    return ShardedQAOAResult(*(x[0] for x in res))


def as_mesh(mesh_spec, device="cuda"):
    """The model axis a mesh spec asks for: a `LocalAxis` in one process,
    a `ProcessGroupAxis` under a launcher that sets ``WORLD_SIZE`` > 1;
    None for no mesh. ``mesh_spec`` is an axis, a ``"model=4"`` string,
    a parsed ``{"model": 4}`` dict, or None."""
    if mesh_spec is None or isinstance(mesh_spec, (LocalAxis, ProcessGroupAxis)):
        return mesh_spec
    spec = (parse_mesh_spec(mesh_spec) if isinstance(mesh_spec, str)
            else dict(mesh_spec))
    if not spec:
        return None
    other = sorted(set(spec) - {"model"})
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only the `model` axis is ported; the data "
            "axis (solve_pool, merge_sharded, striped_beam_width, "
            "global_winner) is still to do (ROADMAP.md §1, the data-axis step)")
    d = int(spec["model"])
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        axis = ProcessGroupAxis.from_env(device)
        if axis.size != d:
            raise ValueError(f"--mesh model={d} under a launcher of "
                             f"{axis.size} processes")
        return axis
    return LocalAxis(d)


def solve_distributed(graph, cfg: para_mod.ParaQAOAConfig, mesh_spec,
                      partition=None, schedule: str = "alternating",
                      device: str | torch.device = "cuda"):
    """End-to-end ParaQAOA with a `model` mesh axis (paper Fig. 3).

    1. partition on the host at the lifted budget ``cfg.n_qubits + h``;
    2. subgraphs of ``cfg.n_qubits`` qubits or fewer solve as one padded
       batch, as in `solve`; the larger ones, grouped by qubit count, run
       through `sharded_qaoa_batch` at the linear-ramp angles, or after
       ``cfg.sharded_opt_steps`` Adam steps through the sharded evolution;
    3. the single-device merge, then ``cfg.refine_steps`` 1-flip steps of
       refinement and the re-score check of `solve`.

    ``mesh_spec`` as `as_mesh` takes it; None (or an empty mesh) runs the
    single-device `solve`. Runs on ``device`` (default the GPU; raises
    when it is missing). Returns the `ParaQAOAOutput` of `solve`.
    """
    dev = resolve_device(device)
    axis = as_mesh(mesh_spec, dev)
    if axis is None:
        return para_mod.solve(graph, cfg, partition=partition, device=dev)
    prob = as_problem(graph)
    graph = prob.graph
    has_lin = prob.has_linear
    lin_host = prob.linear.numpy() if has_lin else None
    device_cap = cfg.n_qubits
    budget = device_cap + axis.h
    steps = cfg.sharded_opt_steps
    tr = trace_mod.get_tracer()
    with tr.span("solve", n=graph.n, n_edges=graph.n_edges,
                 mesh={"model": axis.size}) as root:
        # ---- stage 1: partition at the lifted budget -------------------
        with tr.span("partition", n_qubits=budget) as sp_part:
            part = partition or partition_for_solver(graph, budget)
            sub_lins = split_linear(part, lin_host) if has_lin else None

        # ---- stage 2: single-device batch + the sharded subproblems ----
        qcfg = cfg.qaoa_config()
        small = [i for i, s in enumerate(part.sizes) if s <= device_cap]
        big = [i for i, s in enumerate(part.sizes) if s > device_cap]
        bit_indices = np.zeros((part.m, cfg.top_k), dtype=np.int64)
        with tr.span("solve_pool", m=part.m, n_small=len(small),
                     n_big=len(big)) as sp_solve:
            if small:
                edges, weights, masks = qaoa_mod.pad_subgraph_arrays(
                    [part.subgraphs[i] for i in small], device_cap, device=dev)
                linears = (qaoa_mod.pad_linear_arrays(
                    [sub_lins[i] for i in small], device_cap, device=dev)
                    if has_lin else None)
                res = qaoa_mod.solve_subgraph_batch(edges, weights, masks, qcfg,
                                                    linear=linears)
                bit_indices[small] = res.bitstrings.cpu().numpy()
            g0, b0 = qaoa_mod.linear_ramp_init(cfg.p_layers, cfg.ramp_delta,
                                               device=dev)
            by_n: dict[int, list[int]] = {}
            for i in big:
                by_n.setdefault(part.subgraphs[i].n, []).append(i)
            for n_sub, idxs in sorted(by_n.items()):
                with tr.span("sharded_ascent", n_qubits=n_sub, batch=len(idxs),
                             opt_steps=steps):
                    b_edges, b_weights, _ = qaoa_mod.pad_subgraph_arrays(
                        [part.subgraphs[i] for i in idxs], n_sub, device=dev)
                    b_lins = (qaoa_mod.pad_linear_arrays(
                        [sub_lins[i] for i in idxs], n_sub, device=dev)
                        if has_lin else None)
                    res = sharded_qaoa_batch(
                        b_edges, b_weights, n_sub, g0, b0, axis,
                        top_k=cfg.top_k, schedule=schedule,
                        group=qcfg.mixer_group, opt_steps=steps,
                        learning_rate=cfg.learning_rate, linears=b_lins)
                    bit_indices[idxs] = res.bitstrings.cpu().numpy()

        # ---- stage 3: the single-device merge --------------------------
        with tr.span("merge", m=part.m) as sp_merge:
            assignment, cut, bw = para_mod.merge_candidates(
                part, bit_indices, cfg, linear=lin_host, device=dev)

        # ---- optional beyond-paper refinement ----------------------------
        with tr.span("refine", steps=cfg.refine_steps) as sp_refine:
            assignment, cut = para_mod.refine_merged(part.graph, assignment, cut,
                                                     cfg, lin_host, dev)

    obj = para_mod.checked_value(prob, assignment, cut, cfg)
    timings = {
        "partition_s": sp_part.duration_s,
        "solve_s": sp_solve.duration_s,
        "merge_s": sp_merge.duration_s,
        "refine_s": sp_refine.duration_s,
        "total_s": root.duration_s,
    }
    report = SolveReport(
        method="paraqaoa-distributed",
        n_vertices=graph.n,
        cut_value=obj,
        runtime_s=timings["total_s"],
        extra={"m_subgraphs": part.m, "k": cfg.top_k, "beam": bw,
               "mesh": {"model": axis.size}, "axis": repr(axis),
               "sharded_subproblems": len(big), "sharded_opt_steps": steps,
               "schedule": schedule, **timings},
    )
    return para_mod.ParaQAOAOutput(assignment=assignment, cut_value=obj,
                                   partition=part, report=report,
                                   timings=timings, candidates=bit_indices)
