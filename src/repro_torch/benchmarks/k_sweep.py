"""Paper Fig. 9: the K knob (Selective Distribution Exploration) —
cut value and runtime vs K on a fixed medium graph (port of
``benchmarks/k_sweep.py``).

    python -m repro_torch.benchmarks.k_sweep [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import device_arg, er_graph
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.device import resolve_device


def run(n: int = 80, probs=(0.3, 0.8), ks=(1, 2, 3, 4), seed: int = 0,
        device="cuda"):
    dev = resolve_device(device)
    rows = []
    for p in probs:
        g = er_graph(n, p, seed=seed)
        for k in ks:
            out = solve(
                g, ParaQAOAConfig(n_qubits=10, top_k=k, p_layers=3, opt_steps=25),
                device=dev,
            )
            rows.append(
                {
                    "name": f"k_sweep/K{k}/p{p}",
                    "runtime_s": out.report.runtime_s,
                    "derived": f"cut={out.cut_value:.0f}",
                    "cut": out.cut_value,
                    "k": k,
                    "p": p,
                }
            )
    return rows


if __name__ == "__main__":
    from repro_torch.benchmarks.common import emit

    emit(run(device=device_arg()))
