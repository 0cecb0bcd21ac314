"""Paper Fig. 10: the L knob (level-aware merge parallelism) (port of
``benchmarks/l_sweep.py``).

The paper doubles worker processes (2K^L) and shows runtime halving. The
port's dual shards the frontier: worker count = frontier stripes. On one
card this reports (a) the per-worker work volume (rows x levels), which
halves per doubling exactly as in the paper, and (b) the measured merge
runtime of one worker's stripe vs beam width (linearity check). The
candidates are numpy-seeded, so the plan and every cut are discrete and
equal to the reference's.

    python -m repro_torch.benchmarks.l_sweep [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import device_arg, er_graph, timed
from repro_torch.core import merge as mm
from repro_torch.core.partition import connectivity_preserving_partition
from repro_torch.device import resolve_device


def run(n: int = 120, p: float = 0.5, k: int = 2, ls=(1, 2, 3), seed: int = 0,
        device="cuda"):
    dev = resolve_device(device)
    g = er_graph(n, p, seed=seed)
    part = connectivity_preserving_partition(g, max(n // 9, 2))
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 2 ** min(part.sizes), size=(part.m, k))
    plan = mm.build_merge_plan(part, cand, k, device=dev)
    full = mm.exact_beam_width(k, part.m, cap=1 << 14)

    rows = []
    for l in ls:
        workers = 2 * k**l
        local_rows = max(full // workers, 2 * k)
        # measured: one worker's stripe swept on this device
        res, t = timed(lambda w=local_rows: mm.merge_scan(plan, w))
        rows.append(
            {
                "name": f"l_sweep/L{l}",
                "runtime_s": t,
                "derived": (
                    f"workers={workers};rows_per_worker={local_rows};"
                    f"cut={float(res.cut_value):.0f}"
                ),
            }
        )
    return rows


if __name__ == "__main__":
    from repro_torch.benchmarks.common import emit

    emit(run(device=device_arg()))
