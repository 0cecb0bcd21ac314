"""Kernel microbenchmarks (port of ``benchmarks/kernel_bench.py``). The
reference times its XLA reference path; the port times `kernels.ops`,
which on the card launches the hand-written kernels and on the CPU runs
their plain versions. Derived column reports achieved GFLOP/s or GB/s.

`run_schedules` measures the distributed-statevector collective schedules
(faithful 2-swap/layer vs alternating 1-swap/layer) on a `model` axis
whose shards all live on this card — the measurement behind the
optimization claimed in the `sharded_qaoa` docstring.

    python -m repro_torch.benchmarks.kernel_bench [--schedules | --sharded-engine] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_path, device_arg, er_graph, timed,
                                           write_bench_json)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def run(n_qubits: int = 16, repeats: int = 3, device="cuda"):
    dev = resolve_device(device)
    rows = []
    g = er_graph(n_qubits, 0.5, seed=0)
    dim = 2**n_qubits
    edges, weights = g.edges.to(dev)[None], g.weights.to(dev)[None]

    _, t = timed(ops.cutvals, n_qubits, edges, weights, repeats=repeats)
    rows.append({
        "name": "kernel/cutvals",
        "runtime_s": t,
        "derived": f"Melem_per_s={dim * g.n_edges / t / 1e6:.0f}",
    })

    rng = np.random.default_rng(0)
    re = torch.as_tensor(rng.standard_normal((1, dim), dtype=np.float32), device=dev)
    im = torch.zeros((1, dim), device=dev)
    c = torch.as_tensor(rng.uniform(size=(1, dim)).astype(np.float32), device=dev)

    gamma = torch.full((1,), 0.3, device=dev)
    _, t = timed(ops.apply_phase, re, im, c, gamma, repeats=repeats)
    rows.append({
        "name": "kernel/phase",
        "runtime_s": t,
        "derived": f"GBps={dim * 4 * 5 / t / 1e9:.2f}",
    })

    beta = torch.full((1,), 0.7, device=dev)
    _, t = timed(ops.apply_mixer, re, im, n_qubits, beta, repeats=repeats)
    flops = 4 * 2 * dim * 128 * (n_qubits / 7)
    rows.append({
        "name": "kernel/mixer",
        "runtime_s": t,
        "derived": f"GFLOPs={flops / t / 1e9:.2f}",
    })

    spins = torch.as_tensor(
        rng.integers(0, 2, size=(256, 512)).astype(np.float32) * 2 - 1, device=dev)
    g2 = er_graph(512, 0.2, seed=1)
    adj = g2.dense_adjacency(dev)
    wtot = g2.total_weight().to(dev)
    _, t = timed(ops.cut_batch_dense, spins, adj, wtot, repeats=repeats)
    rows.append({
        "name": "kernel/cutbatch",
        "runtime_s": t,
        "derived": f"GFLOPs={2 * 256 * 512 * 512 / t / 1e9:.2f}",
    })
    return rows


def run_schedules(
    n_qubits: int = 14,
    axis_sizes=(4, 8),
    p_layers: int = 3,
    repeats: int = 10,
    save: bool = True,
    device="cuda",
):
    """Time sharded_qaoa's faithful vs alternating collective schedules.

    Every shard of the `model` axis lives on this card (`Mesh.local`), so
    no axis size is skipped; a swap is a copy on the card, and the
    ``a2a_total`` column records the swap count halving — the quantity
    that matters on a real interconnect.
    """
    from repro_torch.core import distributed as dist
    from repro_torch.core.axis import Mesh

    dev = resolve_device(device)
    rows = []
    g = er_graph(n_qubits, 0.4, seed=3)
    edges, weights = g.edges.to(dev), g.weights.to(dev)
    gammas = torch.linspace(0.2, 0.8, p_layers, device=dev)
    betas = torch.linspace(0.8, 0.2, p_layers, device=dev)
    for d in axis_sizes:
        axis = Mesh.local({"model": d}).model
        times = {}
        for schedule in ("faithful", "alternating"):
            def call():
                return dist.sharded_qaoa(
                    edges, weights, n_qubits, gammas, betas, axis,
                    top_k=4, schedule=schedule,
                )
            timed(call)  # first use outside the timed region
            _, t = timed(call, repeats=repeats)
            times[schedule] = t
            a2a = (2 if schedule == "faithful" else 1) * p_layers
            rows.append({
                "name": f"schedules/sched_{schedule}_d{d}",
                "runtime_s": t,
                "derived": f"a2a_total={a2a}",
                "n_qubits": n_qubits,
                "p_layers": p_layers,
                "axis_size": d,
                "schedule": schedule,
            })
        rows.append({
            "name": f"schedules/sched_speedup_d{d}",
            "runtime_s": 0.0,
            "derived": (
                f"alt_vs_faithful={times['faithful'] / times['alternating']:.3f}x"
            ),
            "axis_size": d,
        })
    if save and rows:
        path = write_bench_json(bench_path("schedules"), "schedules", rows, dev)
        print(f"# wrote {path}")
    return rows


def run_sharded_engine(
    n_qubits: int = 14,
    axis_size: int = 4,
    p_layers: int = 2,
    opt_steps: int = 20,
    repeats: int = 5,
    save: bool = True,
    device="cuda",
):
    """Statevector-engine benchmark (DESIGN.md §2.6, §Perf C7).

    Two measurements:

    (a) fused vs unfused per-shard layer: one `ops.apply_layer` (phase
        fused into the first mixer group's kernel) vs `ops.apply_phase`
        then `ops.apply_mixer`, with a statevector round trip between
        them.
    (b) opt-vs-ramp cut quality: `sharded_qaoa` at linear-ramp parameters
        vs `opt_steps` of the sharded Adam ascent on the same instance —
        the accuracy knob the engine unlocks for oversized subproblems.
        Asserts ⟨cut⟩_opt >= ⟨cut⟩_ramp before writing.
    """
    from repro_torch.core import distributed as dist
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.axis import Mesh

    dev = resolve_device(device)
    rows = []
    h = int(np.log2(axis_size))
    n_local = n_qubits - h
    dim = 2**n_local
    g_loc = er_graph(n_local, 0.4, seed=7)
    cutv = ops.cutvals(n_local, g_loc.edges.to(dev)[None], g_loc.weights.to(dev)[None])
    rng = np.random.default_rng(0)
    re, im = (torch.as_tensor(rng.standard_normal((1, dim), dtype=np.float32)
                              * 2.0 ** (-n_local / 2), device=dev) for _ in range(2))

    gamma = torch.full((1,), 0.4, device=dev)
    beta = torch.full((1,), 0.9, device=dev)

    def unfused():
        r, i = ops.apply_phase(re, im, cutv, gamma)
        return ops.apply_mixer(r, i, n_local, beta)  # separate launches: state round-trips

    def fused():
        return ops.apply_layer(re, im, cutv, gamma, beta, n_local)

    timed(unfused), timed(fused)  # first use outside the timed region
    _, t_unfused = timed(unfused, repeats=repeats)
    _, t_fused = timed(fused, repeats=repeats)
    bytes_moved = dim * 4 * 4  # two planes in + out, per pass
    rows.append({
        "name": f"sharded_engine/layer_unfused_n{n_local}",
        "runtime_s": t_unfused,
        "derived": f"GBps={2 * bytes_moved / t_unfused / 1e9:.2f}",
        "n_local": n_local,
    })
    rows.append({
        "name": f"sharded_engine/layer_fused_n{n_local}",
        "runtime_s": t_fused,
        "derived": f"GBps={bytes_moved / t_fused / 1e9:.2f}",
        "n_local": n_local,
    })
    rows.append({
        "name": "sharded_engine/layer_fusion_speedup",
        "runtime_s": 0.0,
        "derived": f"fused_vs_unfused={t_unfused / t_fused:.3f}x",
        "n_local": n_local,
    })

    axis = Mesh.local({"model": axis_size}).model
    g_big = er_graph(n_qubits, 0.4, seed=3)
    edges, weights = g_big.edges.to(dev), g_big.weights.to(dev)
    gammas, betas = qaoa_mod.linear_ramp_init(p_layers, 0.75, device=dev)
    results = {}
    for label, steps in (("ramp", 0), ("opt", opt_steps)):
        def call():
            return dist.sharded_qaoa(
                edges, weights, n_qubits, gammas, betas, axis,
                top_k=4, opt_steps=steps,
            )
        res, _ = timed(call)  # first use outside the timed region
        _, t = timed(call, repeats=max(2, repeats // 2))
        exp = float(res.expectation.reshape(-1)[0])
        results[label] = exp
        rows.append({
            "name": f"sharded_engine/{label}_d{axis_size}",
            "runtime_s": t,
            "derived": f"exp={exp:.4f};opt_steps={steps}",
            "n_qubits": n_qubits,
            "axis_size": axis_size,
            "p_layers": p_layers,
        })
    assert results["opt"] >= results["ramp"], results
    rows.append({
        "name": f"sharded_engine/opt_vs_ramp_d{axis_size}",
        "runtime_s": 0.0,
        "derived": (
            f"exp_ramp={results['ramp']:.4f};exp_opt={results['opt']:.4f};"
            f"improvement={results['opt'] / results['ramp']:.4f}x"
        ),
        "opt_ge_ramp": True,
    })

    if save:
        path = write_bench_json(bench_path("sharded_engine"), "sharded_engine", rows, dev)
        print(f"# wrote {path}")
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.benchmarks.common import emit

    if "--schedules" in sys.argv:
        emit(run_schedules(device=device_arg()))
    elif "--sharded-engine" in sys.argv:
        emit(run_sharded_engine(device=device_arg()))
    else:
        emit(run(device=device_arg()))
