"""Quickstart: solve a Max-Cut instance with ParaQAOA and score it with the
paper's PEI metric against the GW baseline (port of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core.baselines import goemans_williamson
    from repro_torch.core.graph import Graph
    from repro_torch.core.pei import pei

    # a 120-vertex Erdős-Rényi instance (paper §4.1 generator, seed-stable)
    graph = Graph.erdos_renyi(n=120, p=0.3, seed=0)

    # hardware-dependent: solver qubits; tunable: K (quality) / beam (merge)
    cfg = ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=3, opt_steps=30)
    out = solve(graph, cfg, device=args.device)

    print(f"ParaQAOA cut = {out.cut_value:.0f}  "
          f"(M={out.partition.m} subgraphs, {out.report.runtime_s:.2f}s)")
    for stage, t in out.timings.items():
        print(f"  {stage:12s} {t:.3f}s")

    _, gw_cut, gw_rep = goemans_williamson(graph, steps=250, rounds=64,
                                           device=args.device)
    print(f"GW reference cut = {gw_cut:.0f} ({gw_rep.runtime_s:.2f}s)")
    print(f"AR vs GW = {out.cut_value / gw_cut:.3f}")
    print(f"PEI (GW baseline) = "
          f"{pei(out.cut_value, gw_cut, out.report.runtime_s, gw_rep.runtime_s):.1f}")
    return out, gw_rep


if __name__ == "__main__":
    main()
