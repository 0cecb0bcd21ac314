"""Max-Cut solve CLI.

  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 400 --p 0.1 \
      --qubits 24 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 400 --p 0.1 \
      --qubits 24 --mesh model=4

``--device cpu`` runs the plain PyTorch versions of the kernels (small
``--qubits`` only). ``--mesh model=D`` lifts the qubit budget to
N + log2(D) through the sharded statevector: in one process all D shards
live on one device (`core.axis.LocalAxis`); under a launcher that sets
``WORLD_SIZE`` = D (and ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) each
process holds one shard (`core.axis.ProcessGroupAxis`). A `data` axis,
and the refinement, GW-comparison, oracle-check and trace-export flags of
the reference CLI, are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.solve_maxcut",
        description="Solve Max-Cut with the ParaQAOA divide-and-conquer "
        "pipeline (partition → batched QAOA → level-aware merge) on one GPU.",
    )
    ap.add_argument("--n", type=int, default=400,
                    help="vertex count of the Erdős-Rényi instance")
    ap.add_argument("--p", type=float, default=0.1,
                    help="Erdős-Rényi edge probability")
    ap.add_argument("--seed", type=int, default=0,
                    help="graph-generation seed (runs are seed-stable)")
    ap.add_argument("--problem", choices=("maxcut", "qubo", "mis"),
                    default="maxcut",
                    help="Max-Cut on the generated graph, a random QUBO over "
                    "its topology (quadratic + N(0,1) linear terms), or "
                    "penalty-encoded maximum independent set")
    ap.add_argument("--weights", choices=("unit", "uniform", "spin"),
                    default="unit",
                    help="unit weights, uniform(0.1,1) weights, or ±1 "
                    "spin-glass couplings")
    ap.add_argument("--qubits", type=int, default=10,
                    help="per-solver qubit budget N (paper: 26 on GPU)")
    ap.add_argument("--k", type=int, default=2,
                    help="top-K candidates kept per subgraph (paper's K)")
    ap.add_argument("--layers", type=int, default=3,
                    help="QAOA circuit depth p")
    ap.add_argument("--opt-steps", type=int, default=25,
                    help="Adam steps on <cut>; 0 keeps the linear-ramp init")
    ap.add_argument("--beam", type=int, default=None,
                    help="merge frontier width (default: exact 2*K^M, capped)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                    help="mesh spec 'model=D' (D a power of two): shard "
                    "each subgraph above the qubit budget over D shards, "
                    "lifting the budget to N + log2(D). Omit for the "
                    "single-device pipeline")
    ap.add_argument("--schedule", choices=("faithful", "alternating"),
                    default="alternating",
                    help="swap schedule for sharded subproblems: 2 vs 1 "
                    "qubit swaps per layer")
    ap.add_argument("--sharded-opt-steps", type=int, default=0,
                    help="Adam steps on sharded subproblem angles, through "
                    "the sharded evolution; 0 keeps the linear ramp")
    return ap


def make_instance(args):
    """The instance the flags describe: a `Graph` or a `Problem`."""
    import numpy as np

    from repro_torch.core.graph import Graph, Problem

    if args.weights == "uniform":
        graph = Graph.erdos_renyi_weighted(args.n, args.p, seed=args.seed)
    elif args.weights == "spin":
        graph = Graph.spin_glass(args.n, args.p, seed=args.seed)
    else:
        graph = Graph.erdos_renyi(args.n, args.p, seed=args.seed)
    if args.problem == "mis":
        return graph, Problem.mis(graph)
    if args.problem == "qubo":
        rng = np.random.default_rng(args.seed + 0x9B0)
        e = np.asarray(graph.edges)[: graph.n_edges]
        q = np.asarray(graph.weights)[: graph.n_edges]
        return graph, Problem.qubo(
            graph.n, e, q, linear=rng.normal(size=graph.n).astype(np.float32))
    return graph, graph


def run(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from repro_torch.core import ParaQAOAConfig, solve, solve_distributed
    from repro_torch.core.graph import independent_set_violations

    graph, instance = make_instance(args)
    print(f"[maxcut] G({args.n}, {args.p}): {graph.n_edges} edges "
          f"({args.problem}, {args.weights} weights)")
    cfg = ParaQAOAConfig(
        n_qubits=args.qubits, top_k=args.k, p_layers=args.layers,
        opt_steps=args.opt_steps, beam_width=args.beam,
        sharded_opt_steps=args.sharded_opt_steps,
    )
    if args.mesh:
        out = solve_distributed(instance, cfg, args.mesh,
                                schedule=args.schedule, device=args.device)
        extra = out.report.extra
        print(f"[maxcut] mesh {extra['mesh']} ({extra['axis']}): "
              f"{extra['sharded_subproblems']} model-sharded subproblems "
              f"({extra['schedule']}, sharded_opt_steps="
              f"{extra['sharded_opt_steps']})")
    else:
        out = solve(instance, cfg, device=args.device)
    print(f"[maxcut] value = {out.cut_value:.2f}  "
          f"(M={out.partition.m}, K={args.k}, {out.report.runtime_s:.2f}s, "
          f"{args.device})")
    for stage, t in out.timings.items():
        print(f"  {stage:12s} {t:.2f}s")
    if args.problem == "mis":
        viol = independent_set_violations(graph, out.assignment)
        size = int(np.sum(np.asarray(out.assignment)))
        print(f"[maxcut] mis: |S|={size}, conflict edges inside S: {viol} "
              "(no refinement in this port yet, so S may hold conflicts)")
    return out


if __name__ == "__main__":
    run()
