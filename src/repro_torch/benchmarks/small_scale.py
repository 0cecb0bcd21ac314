"""Paper Table 2 (small-scale): runtime + AR vs brute-force optimum for
GW, QAOA² (CQ's niche: tiny graphs), local search, and ParaQAOA (port of
``benchmarks/small_scale.py``).

14–20 vertices with a 10-qubit solver pool, the reference's knobs (the
paper uses 20–26 vertices on 26-qubit GPU solvers; ratios, not absolutes,
transfer).

    python -m repro_torch.benchmarks.small_scale [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import device_arg, er_graph
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.core.baselines import (
    brute_force_maxcut,
    goemans_williamson,
    local_search,
    qaoa_in_qaoa,
)
from repro_torch.device import resolve_device


def run(sizes=(14, 16, 20), probs=(0.3, 0.5), seed: int = 0, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for p in probs:
        for n in sizes:
            g = er_graph(n, p, seed=seed)
            _, opt, _ = brute_force_maxcut(g, device=dev)
            if opt <= 0:
                continue

            _, v_gw, rep_gw = goemans_williamson(g, steps=200, rounds=64, device=dev)
            _, v_q2, rep_q2 = qaoa_in_qaoa(g, n_qubits=10, opt_steps=25, device=dev)
            _, v_ls, rep_ls = local_search(g, restarts=4, steps=120, device=dev)
            out = solve(
                g,
                ParaQAOAConfig(n_qubits=10, top_k=3, p_layers=3, opt_steps=30),
                device=dev,
            )

            for method, v, t in (
                ("gw", v_gw, rep_gw.runtime_s),
                ("qaoa2", v_q2, rep_q2.runtime_s),
                ("local_search", v_ls, rep_ls.runtime_s),
                ("paraqaoa", out.cut_value, out.report.runtime_s),
            ):
                rows.append(
                    {
                        "name": f"small/{method}/n{n}/p{p}",
                        "runtime_s": t,
                        "derived": f"AR={v / opt:.3f}",
                        "ar": v / opt,
                        "n": n,
                        "p": p,
                        "method": method,
                    }
                )
    return rows


if __name__ == "__main__":
    from repro_torch.benchmarks.common import emit

    emit(run(device=device_arg()))
