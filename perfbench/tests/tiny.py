"""Small cells for the CPU tests: the harness's run at sizes a test can
hold, with the solver's plain PyTorch versions (device "cpu")."""

from __future__ import annotations

import json
import time

from perfbench.lib import bench, spec as spec_mod

CONFIGS = {
    "er": dict(n_qubits=8, n_solvers=1, top_k=2, merge_level=2, beam_width=None,
               beam_cap=64, p_layers=2, opt_steps=6, learning_rate=0.05,
               ramp_delta=0.75, refine_steps=0),
    "torus": dict(n_qubits=8, n_solvers=1, top_k=1, merge_level=2, beam_width=8,
                  beam_cap=64, p_layers=2, opt_steps=6, learning_rate=0.05,
                  ramp_delta=0.75, refine_steps=20),
}
TRAFFIC = {
    "er": {"family": "er", "n": 40, "p": 0.2, "weights": "unit"},
    "torus": {"family": "torus", "rows": 5, "cols": 8, "weights": "pm1"},
}
# limits of the tiny cells: the exact numbers at 0, the QAOA's well above
# the plain float32 path's readings here (below 1e-5) and below a fault's
LIMITS = {"partition_diff": 0, "qaoa_exp_err": 1e-4, "qaoa_prob_err": 1e-4,
          "merge_diff": 0, "value_diff": 0}


def spec(family: str, qaoa_rows: int = 1000, mesh: str | None = None) -> spec_mod.Spec:
    """The tiny cell of ``family``; with ``mesh``, on as many chips as the
    mesh has places."""
    bench_json = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
    chips = 1 if mesh is None else spec_mod.mesh_places(mesh)
    return spec_mod.Spec(name=f"tiny-{family}", chips=chips, config=dict(CONFIGS[family]),
                         traffic=dict(TRAFFIC[family]),
                         cell={"pool": 64, "qaoa_rows": qaoa_rows, "limits": dict(LIMITS)},
                         end_to_end=bench_json["end_to_end"], per_layer=[], mesh=mesh)


def run(family: str, seed: int = 2**31 + 11, seconds: float = 0.3, **kw):
    """(result, checks, correct) of one CPU run of the tiny cell."""
    result, checks = bench.run(spec(family, **kw), seed, seconds, False, "cpu",
                               time.perf_counter(), log=lambda line: None)
    return result, checks, bench.is_correct(result, checks)
