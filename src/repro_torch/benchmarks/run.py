"""Benchmark entrypoint of the port: one function per paper table/figure
(port of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV.  ``--full`` selects paper-sized
instances (the reference's knobs: 10-qubit solvers); default sizes finish
in minutes and preserve every trend the paper reports.

  Table 2  → small_scale      Fig. 9  → k_sweep
  Table 3  → medium_scale     Fig. 10 → l_sweep
  Fig. 11  → medium_scale     Fig. 12 → large_scale
  Figs. 13-14 → pei_eval      (plus kernel microbenches)

    python -m repro_torch.benchmarks.run [--full] [--only SUITE] [--save PATH] [--device cpu]

Before the first suite the kernels are built (or loaded from ``build/``)
and one solve runs untimed, so no row carries a build or a first launch.
``--save`` writes the rows as a JSON list, under ``build/bench/`` only
(the port's record directory; ``results/`` holds the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.benchmarks import (
    k_sweep,
    kernel_bench,
    l_sweep,
    large_scale,
    medium_scale,
    pei_eval,
    small_scale,
)
from repro_torch.benchmarks.common import RESULTS_DIR, emit, er_graph
from repro_torch.device import resolve_device

SUITES = {
    "small_scale": lambda full, dev: small_scale.run(
        sizes=(14, 16, 18, 20) if full else (14, 16), device=dev
    ),
    "medium_scale": lambda full, dev: medium_scale.run(
        sizes=(100, 200, 400) if full else (60, 120), device=dev
    ),
    "k_sweep": lambda full, dev: k_sweep.run(
        ks=(1, 2, 3, 4) if full else (1, 2, 4), device=dev),
    "l_sweep": lambda full, dev: l_sweep.run(device=dev),
    "large_scale": lambda full, dev: large_scale.run(
        sizes=(1000, 2000, 4000, 8000, 16000) if full else (1000, 2000), device=dev
    ),
    "pei_eval": lambda full, dev: pei_eval.run(device=dev),
    "kernel_bench": lambda full, dev: kernel_bench.run(device=dev),
    "sched_bench": lambda full, dev: kernel_bench.run_schedules(
        n_qubits=16 if full else 14, device=dev
    ),
    "sharded_engine": lambda full, dev: kernel_bench.run_sharded_engine(
        n_qubits=16 if full else 14, opt_steps=30 if full else 20, device=dev
    ),
}


def warm_up(dev) -> tuple[float, float]:
    """Build or load the kernels (on the card), then one untimed solve of
    the suites' knobs. Returns (build seconds, warm-up seconds)."""
    from repro_torch.core import ParaQAOAConfig, solve

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    t1 = time.perf_counter()
    solve(er_graph(40, 0.3, seed=0),
          ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=3, opt_steps=2), device=dev)
    return t1 - t0, time.perf_counter() - t1


def save_path(path: str) -> str | None:
    """``--save PATH`` made absolute, or None where it lies outside
    ``build/bench/``."""
    path = os.path.abspath(path)
    root = os.path.abspath(RESULTS_DIR)
    return path if os.path.commonpath([path, root]) == root else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, choices=list(SUITES) + [None])
    ap.add_argument("--save", default=None, help="write rows to JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    save = args.save and save_path(args.save)
    if args.save and save is None:
        ap.error(f"--save {args.save}: the port's records go under {RESULTS_DIR}")
    dev = resolve_device(args.device)

    build_s, warm_s = warm_up(dev)
    print(f"# kernels built or loaded in {build_s:.3f} s; warm-up solve {warm_s:.3f} s "
          f"on {dev}", flush=True)
    all_rows = []
    for name, fn in SUITES.items():
        if args.only and name != args.only:
            continue
        print(f"# === {name} ===", flush=True)
        t0 = time.perf_counter()
        rows = fn(args.full, dev)
        emit(rows)
        print(f"# {name}: {len(rows)} rows in {time.perf_counter() - t0:.3f} s", flush=True)
        all_rows.extend(rows)
    if save:
        os.makedirs(os.path.dirname(save), exist_ok=True)
        with open(save, "w") as f:
            json.dump(all_rows, f, indent=1, default=str)


if __name__ == "__main__":
    main()
