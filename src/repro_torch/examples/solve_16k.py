"""The paper's headline: a >10,000-vertex Max-Cut instance through the
whole ParaQAOA pipeline (partition → batched QAOA → level-aware merge →
refinement), with stage timings and a local-search reference (port of
``examples/solve_16k.py``).

  PYTHONPATH=src python -m repro_torch.examples.solve_16k --qubits 20
  PYTHONPATH=src python -m repro_torch.examples.solve_16k --n 2000 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.solve_16k --qubits 20 --mesh data=4
  PYTHONPATH=src python -m repro_torch.examples.solve_16k --mesh model=4

The flags and their defaults are the reference example's, plus
``--device``: the edge probability 0.01 (≈ 1.28 M edges at 16,000
vertices) and the qubit budget 10 are the reference's CPU-scaled values;
one H100 takes ``--qubits 20`` for the whole batch (843 subgraphs).
``--mesh`` runs `core.distributed.solve_distributed`: ``data=D`` splits
the solver pool over D shards and stripes the merge as ``--merge`` says,
``model=D`` shards the statevector of the subgraphs above the budget. In
one process every shard lives on the one device.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.examples.solve_16k",
        description="ParaQAOA headline instance: >10k-vertex Max-Cut, "
        "optionally through the mesh runtime.")
    ap.add_argument("--n", type=int, default=16_000,
                    help="vertex count (paper headline: 16,000)")
    ap.add_argument("--p", type=float, default=0.01,
                    help="Erdős-Rényi edge probability (CPU-scaled default)")
    ap.add_argument("--qubits", type=int, default=10,
                    help="per-device qubit budget; a model mesh axis lifts "
                    "it by log2(model)")
    ap.add_argument("--k", type=int, default=1,
                    help="top-K candidates kept per subgraph")
    ap.add_argument("--opt-steps", type=int, default=10,
                    help="Adam steps per subgraph QAOA")
    ap.add_argument("--refine", type=int, default=200,
                    help="1-flip local-search steps on the merged cut")
    ap.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                    help="device mesh spec, e.g. 'data=4' or 'data=2,model=2' "
                    "(a model axis lifts the qubit budget by log2(model))")
    ap.add_argument("--merge", choices=("auto", "striped", "single"),
                    default="auto", dest="merge_mode",
                    help="distributed merge policy: 'auto' stripes the "
                    "frontier across data shards only when provably "
                    "exhaustive; 'striped' always stripes (the paper's "
                    "independent workers); 'single' keeps it on one device")
    ap.add_argument("--sharded-opt-steps", type=int, default=0,
                    help="Adam steps on oversized (model-sharded) subproblem "
                    "angles, through the sharded evolution; 0 keeps the "
                    "linear ramp")
    ap.add_argument("--kernel-tuning", action="store_true",
                    help="take the kernels' launch geometry from the "
                    "committed table (src/repro_torch/kernels/"
                    "tuning_cache.json) instead of the built-in defaults")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch.core import ParaQAOAConfig, solve, solve_distributed
    from repro_torch.core.baselines import local_search
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import tuning

    if args.kernel_tuning:
        tuning.set_enabled(True)

    t0 = time.perf_counter()
    print(f"generating G({args.n}, {args.p}) ...", flush=True)
    graph = Graph.erdos_renyi(args.n, args.p, seed=0)
    print(f"  {graph.n_edges} edges ({time.perf_counter() - t0:.1f}s)")

    cfg = ParaQAOAConfig(
        n_qubits=args.qubits, top_k=args.k, p_layers=2,
        opt_steps=args.opt_steps, beam_width=64, refine_steps=args.refine,
        sharded_opt_steps=args.sharded_opt_steps,
    )
    if args.mesh:
        out = solve_distributed(graph, cfg, args.mesh, merge_mode=args.merge_mode,
                                device=args.device)
        extra = out.report.extra
        print(f"mesh {extra['mesh']} ({extra['axis']}): {extra['merge_shards']} "
              f"merge shards ({extra['merge_mode']}), "
              f"{extra['sharded_subproblems']} model-sharded subproblems "
              f"(sharded_opt_steps={extra['sharded_opt_steps']})")
    else:
        out = solve(graph, cfg, device=args.device)
    print(f"ParaQAOA cut = {out.cut_value:.0f} on {args.n} vertices")
    for stage, t in out.timings.items():
        print(f"  {stage:12s} {t:.1f}s")

    # classical sanity reference at the same scale
    _, ls_cut, ls_rep = local_search(graph, restarts=1, steps=300,
                                     device=args.device)
    print(f"local-search reference: {ls_cut:.0f} ({ls_rep.runtime_s:.1f}s)")
    total = float(graph.total_weight())
    print(f"total weight: {total:.0f} (random-cut expectation = {total / 2:.0f})")
    return out, ls_rep


if __name__ == "__main__":
    main()
