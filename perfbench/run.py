"""The benchmark of the ParaQAOA solver's PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, one process a run, on a machine with as
many CUDA devices as the cell asks for. With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced window. Each number of
the check is printed with its limit, last on standard error and last in the
result. The run fails, printing no result, without the devices, when the
solver is missing, or when JAX or the JAX package was loaded.

A cell of more than one chip, whose configuration names a mesh (``"mesh":
"data=4"``), runs one rank a card, each a process of its own
(``perfbench/lib/ranks.py``), through ``core.distributed.solve_distributed``.
It is run the same way, one command on a host with four cards:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds 51 --trace 0

This process then starts the ranks and touches no card. Rank 0's check
lines and result are printed here, last, once every rank has exited 0. The
readings come from all the cards: the fullest card's peak, the mean of the
cards' busy shares, the kernels' roofline over every card's launches and
device time, the mfu over the chips; the spans are rank 0's. Other ranks'
lines on standard error begin ``rank <r>:``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout (the
    solver's own kernels build into ``build/kernels/``)."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.lib import spec as spec_mod

    spec = spec_mod.load(args.workload)
    return run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)


def run_cell(spec, seed: int, seconds: float, trace: bool, device_type: str,
             t_start: float) -> int:
    """Run the cell, in this process on one card, or one rank a card with
    this process starting the ranks (it imports no torch then, to start
    them sooner); print its check and its result; returns the exit code."""
    if spec.chips == 1:
        from perfbench.lib import bench

        short = bench.cuda_shortfall(spec.chips) if device_type == "cuda" else None
        if short:
            _log(short)
            return 2
        result, checks = bench.run(spec, seed, seconds, trace, device_type, t_start,
                                   log=_log)
        bench.refuse_foreign()
        line = bench.result_line(result, checks)
    else:
        from perfbench.lib import ranks

        code, outcome = ranks.launch(spec, seed, seconds, trace, device_type, t_start)
        if code:
            return code
        line, _ = outcome
    for name, c in line["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def _log(line):
    print(line, file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
