"""Shared benchmark helpers (port of ``benchmarks/common.py``): seeded
graphs, the card a run is on, and the JSON envelope the port's benchmarks
write."""

from __future__ import annotations

import functools
import json
import os
import subprocess

import torch

from repro_torch.core.graph import Graph


@functools.lru_cache(maxsize=8)
def er_graph(n: int, p: float, seed: int = 0) -> Graph:
    """G(n, p) from ``seed`` (built once per process: G(16000, 0.01) takes
    seconds on the host)."""
    return Graph.erdos_renyi(n, p, seed=seed)


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
