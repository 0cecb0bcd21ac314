"""The benchmark of the ParaQAOA solver's PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, one process a run, on a machine with as
many CUDA devices as the cell asks for. With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced window. Each number of
the check is printed with its limit, last on standard error and last in the
result. The run fails, printing no result, without the devices, when the
solver is missing, or when JAX or the JAX package was loaded.
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
    import torch

    from perfbench.lib import bench, spec as spec_mod

    spec = spec_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"needs {spec.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result, checks = bench.run(spec, args.seed, args.seconds, bool(args.trace),
                               "cuda", T_START, log=log)
    foreign = bench.foreign_modules()
    if foreign:
        log(f"JAX or the JAX package was loaded: {', '.join(foreign)}")
        return 3
    correct = bench.is_correct(result, checks)
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r}")
    out = {"correct": correct, **result,
           "checks": {name: {"value": value, "limit": limit} for name, value, limit in checks}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
