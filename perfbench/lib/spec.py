"""A cell's specification, found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, and the metric entries that apply to it."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = BENCH.parent

# the fields of the solver's configuration that a configuration file sets
SOLVER_FIELDS = ("n_qubits", "n_solvers", "top_k", "merge_level", "beam_width",
                 "beam_cap", "p_layers", "opt_steps", "learning_rate", "ramp_delta",
                 "refine_steps")


@dataclasses.dataclass
class Spec:
    name: str
    chips: int
    config: dict  # the solver's settings, every one of SOLVER_FIELDS
    traffic: dict
    cell: dict  # pool size, rows checked, limits
    end_to_end: list  # metric entries of BENCHMARK.json for this cell
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    here = root / "perfbench"
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    cell = json.loads((here / "cells" / f"{workload}.json").read_text())
    return Spec(name=workload, chips=int(entry["chips"]),
                config={k: config[k] for k in SOLVER_FIELDS},
                traffic=traffic, cell=cell,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
