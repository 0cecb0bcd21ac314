"""Max-Cut solve CLI.

  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 400 --p 0.1 \
      --qubits 24 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 400 --p 0.1 \
      --qubits 24 --mesh model=4
  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 300 --p 0.1 \
      --qubits 24 --mesh data=4 --merge striped

  PYTHONPATH=src python -m repro_torch.launch.solve_maxcut --n 16 --qubits 8 \
      --refine 20 --check-oracle --compare-gw --trace-out trace.jsonl

``--device cpu`` runs the plain PyTorch versions of the kernels (small
``--qubits`` only). ``--mesh`` names the axes `pod`, `data` and `model`:
``model=D`` lifts the qubit budget to N + log2(D) through the sharded
statevector; ``data=D`` (and ``pod``) splits the solver pool's rows over
D shards and, as ``--merge`` says, stripes the merge frontier over them.
In one process every shard lives on one device (`core.axis.LocalAxis`);
under a launcher that sets ``WORLD_SIZE`` to the product of the sizes
(and ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) each process holds one
shard of every axis (`core.axis.Mesh.from_env`).
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
    ap.add_argument("--check-oracle", action="store_true",
                    help="small-n only (n <= 18): compare the solved "
                    "objective against exhaustive brute force and, for "
                    "--problem mis, assert the selected set is independent")
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
    ap.add_argument("--refine", type=int, default=0,
                    help="1-flip local-search steps on the merged cut "
                    "(beyond-paper; 0 disables)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                    help="device mesh spec, e.g. 'data=2' or 'data=2,model=4' "
                    "(axes: pod/data/model; model must be a power of two and "
                    "lifts the qubit budget to N + log2(model)). Omit for the "
                    "single-device pipeline. In one process every shard "
                    "lives on the one device")
    ap.add_argument("--schedule", choices=("faithful", "alternating"),
                    default="alternating",
                    help="swap schedule for sharded subproblems: 2 vs 1 "
                    "qubit swaps per layer")
    ap.add_argument("--sharded-opt-steps", type=int, default=0,
                    help="Adam steps on sharded subproblem angles, through "
                    "the sharded evolution; 0 keeps the linear ramp")
    ap.add_argument("--merge", choices=("auto", "striped", "single"),
                    default="auto", dest="merge_mode",
                    help="distributed merge policy: 'auto' stripes the "
                    "frontier across data shards only when provably "
                    "exhaustive (cut identical to the single-device run); "
                    "'striped' always stripes (the paper's independent "
                    "workers; may differ in the beam-pruned regime); "
                    "'single' keeps the merge on one device")
    ap.add_argument("--compare-gw", action="store_true",
                    help="also run the Goemans-Williamson baseline and "
                    "report AR / PEI against it")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="export the pipeline span trace here (tracing is "
                    "off unless this is set)")
    ap.add_argument("--trace-format", choices=("jsonl", "chrome"),
                    default="jsonl",
                    help="trace export format: 'jsonl' (one span per "
                    "line) or 'chrome' (Perfetto-loadable trace events)")
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

    import contextlib

    import numpy as np

    from repro_torch.core import ParaQAOAConfig, solve, solve_distributed
    from repro_torch.core.graph import independent_set_violations
    from repro_torch.core.pei import pei
    from repro_torch.obs.trace import Tracer, use_tracer

    graph, instance = make_instance(args)
    print(f"[maxcut] G({args.n}, {args.p}): {graph.n_edges} edges "
          f"({args.problem}, {args.weights} weights)")
    cfg = ParaQAOAConfig(
        n_qubits=args.qubits, top_k=args.k, p_layers=args.layers,
        opt_steps=args.opt_steps, beam_width=args.beam,
        refine_steps=args.refine,
        sharded_opt_steps=args.sharded_opt_steps,
    )
    # tracing is on only when an export path is asked for: the solve's
    # ambient-tracer spans become the exported trace
    tracer = Tracer(record=True) if args.trace_out else None
    scope = use_tracer(tracer) if tracer else contextlib.nullcontext()
    with scope:
        if args.mesh:
            out = solve_distributed(instance, cfg, args.mesh,
                                    schedule=args.schedule,
                                    merge_mode=args.merge_mode,
                                    device=args.device)
            extra = out.report.extra
            print(f"[maxcut] mesh {extra['mesh']} ({extra['axis']}): "
                  f"{extra['merge_shards']} merge shards "
                  f"({extra['merge_mode']}), "
                  f"{extra['sharded_subproblems']} model-sharded subproblems "
                  f"({extra['schedule']}, sharded_opt_steps="
                  f"{extra['sharded_opt_steps']})")
        else:
            out = solve(instance, cfg, device=args.device)
    if tracer is not None:
        tracer.export(args.trace_out, args.trace_format)
        print(f"[maxcut] trace ({args.trace_format}, "
              f"{len(tracer.spans)} spans): {args.trace_out}")
    print(f"[maxcut] value = {out.cut_value:.2f}  "
          f"(M={out.partition.m}, K={args.k}, {out.report.runtime_s:.2f}s, "
          f"{args.device})")
    for stage, t in out.timings.items():
        print(f"  {stage:12s} {t:.2f}s")

    if args.problem == "mis":
        viol = independent_set_violations(graph, out.assignment)
        size = int(np.sum(np.asarray(out.assignment)))
        print(f"[maxcut] mis: |S|={size}, conflict edges inside S: {viol}")
        assert viol == 0, (
            f"penalty-QUBO MIS produced {viol} conflict edge(s): raise the "
            "penalty or the refine/merge budget")

    if args.check_oracle:
        if args.n > 18:
            raise SystemExit("--check-oracle needs --n <= 18 (exhaustive)")
        from repro_torch.core.baselines.brute_force import brute_force_problem

        _, opt, rep = brute_force_problem(instance, device=args.device)
        gap = opt - out.cut_value
        print(f"[maxcut] oracle: brute-force optimum {opt:.2f} "
              f"({rep.runtime_s:.2f}s), gap {gap:.4f}")
        assert gap > -1e-3 * max(1.0, abs(opt)), (
            "solver reported a value above the exhaustive optimum: objective "
            "accounting is broken", out.cut_value, opt)

    if args.compare_gw:
        from repro_torch.core.baselines import goemans_williamson

        _, v_gw, rep = goemans_williamson(graph, steps=250, rounds=64,
                                          device=args.device)
        print(f"[maxcut] GW reference: {v_gw:.0f} ({rep.runtime_s:.2f}s)  "
              f"AR={out.cut_value / v_gw:.3f}  "
              f"PEI={pei(out.cut_value, v_gw, out.report.runtime_s, rep.runtime_s):.1f}")
    return out


if __name__ == "__main__":
    run()
