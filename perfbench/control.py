"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed, one solve of the seed's first instance and the
check's numbers of it (the solver's readings), and for the control seeds
the same numbers of the control, the reference in TF32 put in the
solver's place on the same drawn rows.

    python3 perfbench/control.py --workload n26-er400 --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--out chiprun_out/control-n26-er400.jsonl]

One JSON line a seed. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.lib import bench, check, generate, spec as spec_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve

    spec = spec_mod.load(args.workload)
    device = torch.device(args.device)
    cfg = ParaQAOAConfig(**spec.config)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        inst = generate.instance(spec.traffic, seed, 0, device)
        t0 = time.perf_counter()
        res = solve(bench.graph_of(Graph, inst), cfg, device=device)
        t1 = time.perf_counter()
        solved = [bench.solved_of(inst, res)]
        del res
        nums, plans = check.exact_numbers(spec.config, solved, device)
        t2 = time.perf_counter()
        q = check.qaoa_numbers(spec.config, solved, plans, seed, int(spec.cell["qaoa_rows"]),
                               device, control=seed in controls)
        t3 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "solver": {**nums, **q["solver"]},
                "control": q.get("control"), "solve_s": t1 - t0, "exact_check_s": t2 - t1,
                "qaoa_check_s": t3 - t2,
                "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
