"""Paper Figs. 13-14: Performance Efficiency Index across methods/scales,
GW as the medium-scale baseline (Fig 13), QAOA2 as the large-scale
baseline (Fig 14) (port of ``benchmarks/pei_eval.py``).

    python -m repro_torch.benchmarks.pei_eval [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import device_arg, er_graph
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.core.baselines import goemans_williamson, qaoa_in_qaoa
from repro_torch.core.pei import pei
from repro_torch.device import resolve_device


def run(sizes=(60, 120), probs=(0.1, 0.5), seed: int = 0, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for p in probs:
        for n in sizes:
            g = er_graph(n, p, seed=seed)
            _, v_gw, rep_gw = goemans_williamson(g, steps=250, rounds=64, device=dev)
            _, v_q2, rep_q2 = qaoa_in_qaoa(g, n_qubits=10, opt_steps=25, device=dev)
            out = solve(
                g, ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=3, opt_steps=25),
                device=dev,
            )
            # Fig 13 protocol: GW is the AR + EF baseline, alpha=1e-3
            pei_q2 = pei(v_q2, v_gw, rep_q2.runtime_s, rep_gw.runtime_s)
            pei_para = pei(
                out.cut_value, v_gw, out.report.runtime_s, rep_gw.runtime_s
            )
            # Fig 14 protocol: QAOA2 as baseline, alpha=1e-4
            pei_para_vs_q2 = pei(
                out.cut_value, v_q2, out.report.runtime_s, rep_q2.runtime_s,
                alpha=1e-4,
            )
            rows.append(
                {
                    "name": f"pei/n{n}/p{p}",
                    "runtime_s": out.report.runtime_s,
                    "derived": (
                        f"PEI_qaoa2={pei_q2:.1f};PEI_paraqaoa={pei_para:.1f};"
                        f"PEI_para_vs_q2={pei_para_vs_q2:.1f}"
                    ),
                    "pei_q2": pei_q2,
                    "pei_para": pei_para,
                }
            )
    return rows


if __name__ == "__main__":
    from repro_torch.benchmarks.common import emit

    emit(run(device=device_arg()))
