"""Paper Table 3 + Fig. 11 (medium-scale): ParaQAOA vs QAOA² runtime and
speedup; AR heatmap against the GW reference (brute force infeasible)
(port of ``benchmarks/medium_scale.py``).

Default 60–200 vertices, ``run.py --full`` 100–400 (the paper's sizes).
The paper's QAOA² numbers come from its host-side exhaustive merge; this
reimplementation solves the same contracted problem on the card, so
speedups here are *conservative*.

    python -m repro_torch.benchmarks.medium_scale [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import device_arg, er_graph
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.core.baselines import goemans_williamson, qaoa_in_qaoa
from repro_torch.device import resolve_device


# the suite's knobs, the reference's; phase 26 of `chip_smoke.py` solves
# the same instances with them again
GW_KNOBS = dict(steps=250, rounds=64)
Q2_KNOBS = dict(n_qubits=10, opt_steps=25)
PARA_CFG = ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=3, opt_steps=25)


def run(sizes=(60, 120, 200), probs=(0.1, 0.5), seed: int = 0, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for p in probs:
        for n in sizes:
            g = er_graph(n, p, seed=seed)
            _, v_gw, rep_gw = goemans_williamson(g, **GW_KNOBS, device=dev)
            _, v_q2, rep_q2 = qaoa_in_qaoa(g, **Q2_KNOBS, device=dev)
            out = solve(g, PARA_CFG, device=dev)
            speedup = rep_q2.runtime_s / max(out.report.runtime_s, 1e-9)
            for method, v, t in (
                ("gw", v_gw, rep_gw.runtime_s),
                ("qaoa2", v_q2, rep_q2.runtime_s),
                ("paraqaoa", out.cut_value, out.report.runtime_s),
            ):
                rows.append(
                    {
                        "name": f"medium/{method}/n{n}/p{p}",
                        "runtime_s": t,
                        "derived": (
                            f"AR_vs_gw={v / max(v_gw, 1e-9):.3f}"
                            + (f";speedup_vs_qaoa2={speedup:.1f}x"
                               if method == "paraqaoa" else "")
                        ),
                        "method": method,
                        "ar_vs_gw": v / max(v_gw, 1e-9),
                        "n": n,
                        "p": p,
                    }
                )
    return rows


if __name__ == "__main__":
    from repro_torch.benchmarks.common import emit

    emit(run(device=device_arg()))
