"""A cell's specification, found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, and the metric entries that apply to it.

A configuration may name a mesh (``"mesh": "data=4"``, the solver's
``--mesh`` spec) and a ``merge_mode``: its cells then solve through
``core.distributed.solve_distributed``, one rank a card, on as many cards
as the mesh has places."""

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
# the merge policies of solve_distributed (core/distributed.py's MERGE_MODES)
MERGE_MODES = ("auto", "striped", "single")


@dataclasses.dataclass
class Spec:
    name: str
    chips: int
    config: dict  # the solver's settings, every one of SOLVER_FIELDS
    traffic: dict
    cell: dict  # pool size, rows checked, limits
    end_to_end: list  # metric entries of BENCHMARK.json for this cell
    per_layer: list
    mesh: str | None = None  # the mesh spec of a solve over cards, None for one card
    merge_mode: str = "auto"


def mesh_places(mesh: str) -> int:
    """The places of a mesh spec such as ``"data=2,model=2"``: the product
    of its axes' sizes."""
    places = 1
    for item in mesh.split(","):
        places *= int(item.partition("=")[2])
    return places


def check_mesh(workload: str, chips: int, mesh: str | None, merge_mode: str) -> None:
    """Raise where the cell's chips are not its mesh's places, or the merge
    policy is not one of the solver's."""
    if mesh is None:
        if chips != 1:
            raise ValueError(f"workload {workload!r} asks for {chips} chips and its "
                             "configuration names no mesh")
    elif mesh_places(mesh) != chips:
        raise ValueError(f"workload {workload!r} asks for {chips} chips; its mesh "
                         f"{mesh!r} has {mesh_places(mesh)} places")
    if merge_mode not in MERGE_MODES:
        raise ValueError(f"merge_mode {merge_mode!r} is not one of {MERGE_MODES}")


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
    chips, mesh = int(entry["chips"]), config.get("mesh")
    merge_mode = config.get("merge_mode", "auto")
    check_mesh(workload, chips, mesh, merge_mode)
    return Spec(name=workload, chips=chips,
                config={k: config[k] for k in SOLVER_FIELDS},
                traffic=traffic, cell=cell,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
                mesh=mesh, merge_mode=merge_mode)
