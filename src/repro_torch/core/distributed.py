"""ParaQAOA on a device mesh (the port of ``repro/core/distributed.py``).

Three programs over the axes of a `core.axis.Mesh`, and the solve that
wires them together:

1. `solve_pool`: the solver pool, the paper's "N_s QAOA solvers × T
   rounds", with the subgraph batch split over the `data` (and `pod`)
   axes. In one process every shard's rows run as one batch, one launch
   per op; over ranks each rank solves its contiguous block of rows and
   the results are gathered.
2. `sharded_qaoa`: one n-qubit QAOA circuit with its 2^n amplitudes
   sharded over the D shards of the `model` axis: only the h = log2(D)
   "global" qubits need mixing across shards, and one qubit swap a layer
   rotates them into locality. That lifts the per-device qubit cap N to
   N + h. `sharded_qaoa_batch` runs a batch of same-n subgraphs as rows,
   as many per launch as the card holds.
3. `merge_sharded`: the merge frontier striped over the innermost data
   axis at the paper's level L; `merge.global_winner` picks the best
   stripe.

`solve_distributed` partitions at the lifted budget, solves the subgraphs
of N qubits or fewer through the pool and the larger ones, grouped by n,
through `sharded_qaoa_batch`, then merges striped or on one device as
``merge_mode`` says.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import merge as merge_mod
from repro_torch.core import paraqaoa as para_mod
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.axis import LocalAxis, Mesh, ProcessGroupAxis
from repro_torch.core.graph import as_problem
from repro_torch.core.partition import partition_for_solver, split_linear
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import build_mesh, parse_mesh_spec
from repro_torch.obs import trace as trace_mod

MERGE_MODES = ("auto", "striped", "single")

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


def solve_pool(edges, weights, masks, cfg: qaoa_mod.QAOAConfig, mesh,
               axes=("data",), linears=None) -> qaoa_mod.QAOAResult:
    """The subgraph batch solved over the mesh's batch ``axes``.

    Pads the batch to a multiple of their product with empty rows (mask 1,
    no edges, zero linear terms). Shard d takes the d-th contiguous block
    of rows, as ``shard_map``'s ``P(axes)`` lays them out. In one process
    every shard's rows run as one batch; over ranks each rank solves its
    block and every field is gathered. The padding is stripped after the
    gather. ``mesh`` is a `Mesh` or what `as_mesh` takes; ``linears``
    (B, n_qubits) optional per-vertex terms. Returns the `QAOAResult` of
    `qaoa.solve_subgraph_batch` on the same rows, the same on every rank.
    """
    mesh = as_mesh(mesh, edges.device)
    pool = mesh.over(axes)
    m = edges.shape[0]
    pad = -m % pool.size
    if pad:
        def grow(x, fill):
            return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])

        edges, weights, masks = grow(edges, 0), grow(weights, 0), grow(masks, 1)
        linears = None if linears is None else grow(linears, 0)
    per = (m + pad) // pool.size
    rows = slice(pool.offset * per, (pool.offset + pool.local) * per)
    res = qaoa_mod.solve_subgraph_batch(
        edges[rows], weights[rows], masks[rows], cfg,
        linear=None if linears is None else linears[rows])
    return qaoa_mod.QAOAResult(*(pool.gather_rows(x)[:m] for x in res))


def merge_sharded(plan: merge_mod.MergePlan, beam_width: int, mesh,
                  axis: str = "data", split_level: int = 1):
    """The merge frontier striped over the mesh's ``axis`` at
    ``split_level``: each of its D shards sweeps its own stripe of
    ``beam_width`` rows (the global frontier is D × beam_width, the
    paper's 2K^L workers), and `merge.global_winner` picks the best. The
    stripes of one process sweep together. Returns (assignment (V,) int8,
    value), the same on every rank."""
    ax = as_mesh(mesh, plan.lo.device).axes[axis]
    ids = ax.shard_ids(plan.lo.device)
    res = merge_mod.merge_scan(plan, beam_width, shard_id=ids,
                               n_shards=ax.size, split_level=split_level)
    return merge_mod.global_winner(res, ax, ids)


def as_mesh(mesh_spec, device="cuda"):
    """The `Mesh` a spec asks for, None for no mesh. ``mesh_spec`` is a
    `Mesh`, a ``"data=2,model=4"`` string, a parsed ``{"data": 2}`` dict,
    a lone axis (taken as the `model` axis), or None. In one process every
    axis is a `LocalAxis`; under a launcher that sets ``WORLD_SIZE`` > 1
    the axes are process groups (`Mesh.from_env`)."""
    if mesh_spec is None or isinstance(mesh_spec, Mesh):
        return mesh_spec
    if isinstance(mesh_spec, (LocalAxis, ProcessGroupAxis)):
        return Mesh({"model": mesh_spec})
    if not isinstance(mesh_spec, str):
        if not mesh_spec:
            return None
        # the string parser's checks (names, sizes, order) for a dict too
        mesh_spec = ",".join(f"{k}={v}" for k, v in dict(mesh_spec).items())
    return build_mesh(parse_mesh_spec(mesh_spec), device)


def solve_distributed(graph, cfg: para_mod.ParaQAOAConfig, mesh_spec,
                      partition=None, schedule: str = "alternating",
                      split_level: int | None = None, merge_mode: str = "auto",
                      device: str | torch.device = "cuda"):
    """End-to-end ParaQAOA on a device mesh (paper Fig. 3).

    1. partition on the host at the lifted budget ``cfg.n_qubits + h``,
       h = log2 of the `model` axis (0 without one);
    2. subgraphs of ``cfg.n_qubits`` qubits or fewer solve through
       `solve_pool` over the `data` (and `pod`) axes, or as the one batch
       of `solve` without them; the larger ones, grouped by qubit count,
       run through `sharded_qaoa_batch` over `model` at the linear-ramp
       angles, or after ``cfg.sharded_opt_steps`` Adam steps through the
       sharded evolution; in one process they run once, not once a data
       shard;
    3. the merge, as ``merge_mode`` says (``distributed.py:577-622``):
       "auto" stripes the frontier over the innermost data axis only where
       the striped sweep is provably exhaustive, so the value equals the
       single-device merge's; "striped" always stripes (the paper's
       independent workers, a different heuristic once the beam prunes);
       "single" keeps the merge on one device. The split is at
       ``split_level`` (default ``cfg.merge_level``); then
       ``cfg.refine_steps`` 1-flip steps and the re-score check of `solve`.

    ``mesh_spec`` as `as_mesh` takes it; None (or an empty mesh) runs the
    single-device `solve`. Raises ValueError for an unknown ``merge_mode``
    and for subgraphs above the device cap on a mesh without `model`. Runs
    on ``device`` (default the GPU; raises when it is missing). Returns
    the `ParaQAOAOutput` of `solve`.
    """
    dev = resolve_device(device)
    if merge_mode not in MERGE_MODES:
        raise ValueError(f"unknown merge_mode {merge_mode!r}")
    mesh = as_mesh(mesh_spec, dev)
    if mesh is None or not mesh.axes:
        return para_mod.solve(graph, cfg, partition=partition, device=dev)
    prob = as_problem(graph)
    graph = prob.graph
    has_lin = prob.has_linear
    lin_host = prob.linear.numpy() if has_lin else None
    data_axes = mesh.data_axes
    model = mesh.model
    device_cap = cfg.n_qubits
    budget = device_cap + (model.h if model else 0)
    steps = cfg.sharded_opt_steps
    tr = trace_mod.get_tracer()
    with tr.span("solve", n=graph.n, n_edges=graph.n_edges,
                 mesh=mesh.shape) as root:
        # ---- stage 1: partition at the lifted budget -------------------
        with tr.span("partition", n_qubits=budget) as sp_part:
            part = partition or partition_for_solver(graph, budget)
            sub_lins = split_linear(part, lin_host) if has_lin else None

        # ---- stage 2: the solver pool + the sharded subproblems --------
        qcfg = cfg.qaoa_config()
        small = [i for i, s in enumerate(part.sizes) if s <= device_cap]
        big = [i for i, s in enumerate(part.sizes) if s > device_cap]
        if big and model is None:
            raise ValueError(
                f"subgraphs of {max(part.sizes)} qubits exceed the "
                f"{device_cap}-qubit device cap and the mesh has no `model` axis")
        bit_indices = np.zeros((part.m, cfg.top_k), dtype=np.int64)
        with tr.span("solve_pool", m=part.m, n_small=len(small),
                     n_big=len(big)) as sp_solve:
            if small:
                edges, weights, masks = qaoa_mod.pad_subgraph_arrays(
                    [part.subgraphs[i] for i in small], device_cap, device=dev)
                linears = (qaoa_mod.pad_linear_arrays(
                    [sub_lins[i] for i in small], device_cap, device=dev)
                    if has_lin else None)
                if data_axes:
                    res = solve_pool(edges, weights, masks, qcfg, mesh,
                                     axes=data_axes, linears=linears)
                else:
                    res = qaoa_mod.solve_subgraph_batch(edges, weights, masks,
                                                        qcfg, linear=linears)
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
                        b_edges, b_weights, n_sub, g0, b0, model,
                        top_k=cfg.top_k, schedule=schedule,
                        group=qcfg.mixer_group, opt_steps=steps,
                        learning_rate=cfg.learning_rate, linears=b_lins)
                    bit_indices[idxs] = res.bitstrings.cpu().numpy()

        # ---- stage 3: the merge, striped where the policy allows -------
        with tr.span("merge", m=part.m) as sp_merge:
            plan, bw = para_mod.merge_inputs(part, bit_indices, cfg,
                                             linear=lin_host, device=dev)
            # the merge stripes over the innermost data axis only; a `pod`
            # axis replicates the striped sweep rather than widening it
            n_shards = mesh.shape[data_axes[-1]] if data_axes else 1
            sl = min(cfg.merge_level if split_level is None else split_level,
                     part.m - 1)
            per_shard = None
            if n_shards > 1 and part.m > 1 and merge_mode != "single":
                w_exact = merge_mod.striped_beam_width(
                    cfg.top_k, part.m, n_shards, sl, cap=cfg.beam_cap)
                if w_exact is not None and (cfg.beam_width is None
                                            or bw >= 2 * cfg.top_k**part.m):
                    per_shard = w_exact
                elif merge_mode == "striped":
                    per_shard = max(-(-bw // n_shards), 2 * cfg.top_k)
            if per_shard is not None:
                assign, val = merge_sharded(plan, per_shard, mesh,
                                            axis=data_axes[-1], split_level=sl)
                assignment, cut = assign.cpu().numpy(), float(val)
            else:
                merged = merge_mod.merge_scan(plan, bw)
                assignment = merged.assignment.cpu().numpy()
                cut = float(merged.cut_value)
            del plan

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
               "mesh": mesh.shape, "axis": repr(mesh),
               "merge_shards": n_shards if per_shard is not None else 1,
               "merge_mode": merge_mode, "merge_per_shard_beam": per_shard,
               "sharded_subproblems": len(big), "sharded_opt_steps": steps,
               "schedule": schedule, **timings},
    )
    return para_mod.ParaQAOAOutput(assignment=assignment, cut_value=obj,
                                   partition=part, report=report,
                                   timings=timings, candidates=bit_indices)
