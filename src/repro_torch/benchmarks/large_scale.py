"""Paper Fig. 12 (large-scale scalability): 1,000-16,000 vertices (port
of ``benchmarks/large_scale.py``).

The reference's knobs: a 10-qubit solver, edge probability 0.02; the
paper's 16k-vertex headline instance at the largest budget one card takes
is ``python -m repro_torch.examples.solve_16k``.

`run_distributed` (``python -m repro_torch.benchmarks.large_scale
--distributed``) compares single-device vs pool-parallel *stage* timings
on the same instances, through the `solve_distributed` pipeline over a
``data`` mesh whose shards are row blocks of one batch on this card, and
writes the comparison to ``build/bench/BENCH_distributed.json``. All
shards share one card, so cut parity — not speedup — is the expected
outcome; the row's per-stage split is the quantity the paper's Fig. 12
scales with device count.

    python -m repro_torch.benchmarks.large_scale [--distributed] [--device cpu]
"""

from __future__ import annotations

from repro_torch.benchmarks.common import device_arg, er_graph
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.device import resolve_device


def run(sizes=(1000, 2000, 4000), p: float = 0.02, seed: int = 0,
        n_qubits: int = 10, opt_steps: int = 12, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for n in sizes:
        g = er_graph(n, p, seed=seed)
        out = solve(
            g,
            ParaQAOAConfig(
                n_qubits=n_qubits, top_k=1, p_layers=2, opt_steps=opt_steps,
                beam_width=64,
            ),
            device=dev,
        )
        rows.append(
            {
                "name": f"large/n{n}/p{p}",
                "runtime_s": out.report.runtime_s,
                "derived": (
                    f"cut={out.cut_value:.0f};m={out.partition.m};"
                    f"edges={g.n_edges}"
                ),
            }
        )
    return rows


def run_distributed(sizes=(1000, 2000), p: float = 0.02, seed: int = 0,
                    n_qubits: int = 10, opt_steps: int = 12,
                    data: int = 2, save: bool = True, device="cuda"):
    """Single-device vs pool-parallel stage timings on the same instances.

    The ``data`` mesh is the port's `core.axis.Mesh` in one process: each
    shard a row block of one batch on ``device``. Each instance solves
    twice with identical configs; the distributed row records
    mesh/merge metadata so the JSON is self-describing.
    """
    from repro_torch.core import solve_distributed

    dev = resolve_device(device)
    rows = []
    cfg_kw = dict(n_qubits=n_qubits, top_k=1, p_layers=2,
                  opt_steps=opt_steps, beam_width=64)
    mesh_spec = {"data": data}
    for n in sizes:
        g = er_graph(n, p, seed=seed)
        single = solve(g, ParaQAOAConfig(**cfg_kw), device=dev)
        dist = solve_distributed(g, ParaQAOAConfig(**cfg_kw), mesh_spec, device=dev)
        for label, out in (("single", single), ("pool", dist)):
            row = {
                "name": f"distributed/{label}_n{n}/p{p}",
                "runtime_s": out.report.runtime_s,
                "derived": f"cut={out.cut_value:.0f};m={out.partition.m}",
                "mode": label,
                "n": n,
                "cut": out.cut_value,
                **out.timings,
            }
            if label == "pool":
                row["mesh"] = out.report.extra["mesh"]
                row["merge_shards"] = out.report.extra["merge_shards"]
                row["merge_mode"] = out.report.extra["merge_mode"]
            rows.append(row)
        rows.append({
            "name": f"distributed/stage_speedup_n{n}",
            "runtime_s": 0.0,
            "derived": (
                f"solve={single.timings['solve_s'] / max(dist.timings['solve_s'], 1e-9):.3f}x;"
                f"merge={single.timings['merge_s'] / max(dist.timings['merge_s'], 1e-9):.3f}x;"
                f"cut_equal={abs(single.cut_value - dist.cut_value) < 0.5}"
            ),
            "n": n,
        })
    if save and rows:
        from repro_torch.benchmarks.common import bench_path, write_bench_json

        path = write_bench_json(bench_path("distributed"), "distributed", rows, dev)
        print(f"# wrote {path}")
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.benchmarks.common import emit

    if "--distributed" in sys.argv:
        emit(run_distributed(device=device_arg()))
    else:
        emit(run(device=device_arg()))
