"""Shared benchmark helpers (port of ``benchmarks/common.py``): seeded
graphs, timing, CSV, the card a run is on, and the JSON envelope the
port's benchmarks write.

Every record of the port goes under ``build/bench/`` (`RESULTS_DIR`);
``results/BENCH_*.json`` are the JAX package's records and keep its
envelope."""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time

import torch

from repro_torch.core.graph import Graph

RESULTS_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "..", "..", "..", "build", "bench"))


@functools.lru_cache(maxsize=8)
def er_graph(n: int, p: float, seed: int = 0) -> Graph:
    """G(n, p) from ``seed`` (built once per process: G(16000, 0.01) takes
    seconds on the host)."""
    return Graph.erdos_renyi(n, p, seed=seed)


def device_arg(argv=None) -> str:
    """The ``--device`` flag of a driver's command line (default ``cuda``);
    the driver's other flags are left to it."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    return ap.parse_known_args(argv)[0].device


def timed(fn, *args, repeats: int = 1, **kwargs):
    """(result, seconds), the best of ``repeats`` calls. Where this process
    has used CUDA, each call ends in ``torch.cuda.synchronize()``, so the
    time holds the card's work and not only its launch."""
    best = float("inf")
    result = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return result, best


def emit(rows, header=None):
    """Print rows as `name,us_per_call,derived` CSV (spec format)."""
    for r in rows:
        name = r["name"]
        us = r.get("us_per_call", r.get("runtime_s", 0) * 1e6)
        derived = r.get("derived", "")
        print(f"{name},{us:.1f},{derived}")


def bench_path(suite: str) -> str:
    """The default record of ``suite``: ``build/bench/BENCH_<suite>.json``."""
    return os.path.join(RESULTS_DIR, f"BENCH_{suite}.json")


def card_info(device) -> tuple[str, str | None]:
    """(name, power limit) of the card ``device`` lies on, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; ("cpu", None) for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, _, limit = out.splitlines()[0].rpartition(",")
    return name.strip(), limit.strip()


def write_bench_json(path: str, suite: str, rows, device) -> str:
    """Write ``rows`` to ``path`` in the port's envelope: the suite, torch
    and CUDA versions, the card and its power limit, the device count."""
    card, limit = card_info(device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "suite": suite,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "card": card,
            "power_limit": limit,
            "device_count": torch.cuda.device_count() if card != "cpu" else 0,
            "rows": rows,
        }, f, indent=1, default=str)
        f.write("\n")
    return path
