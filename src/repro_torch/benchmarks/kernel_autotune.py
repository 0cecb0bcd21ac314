"""Per-kernel block-shape sweep on the H100 (port of
``benchmarks/kernel_autotune.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_autotune [--write] [--write-cache]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_autotune --smoke --device cpu

For every tunable op (`tuning.TUNABLE_OPS`) and shape bucket it times each
candidate launch geometry, the kernel's built-in one always first, so the
winner can never be slower than the default, and records the time against
the `repro_torch.roofline.analysis` bound of the card. The shapes are the
main path's, at full width: the 18 subgraphs of G(400, 0.1, seed 0) at
N = 24 qubits for the state ops and ``cutvals``; the sharded path's
(4, 2^24) index table and its 15 edge rows of 26 qubits for
``cutvals_at``; and ``cut_batch_dense`` at the merge beam's width (2^18
seeded random ±1 assignments of that graph) and at the scale of ``examples/solve_16k.py``
(4,096 rows of G(16000, 0.01, seed 0)).

``--write`` writes the rows to ``--out`` (default
``build/autotune/kernel_autotune.json``); ``--write-cache`` writes the
winners to the committed table ``src/repro_torch/kernels/tuning_cache.json``,
and refuses entries from a CPU sweep: on the CPU the plain versions have
no launch geometry, so ``--device cpu`` checks the harness only.

Every time flows through `tuning.measure` and its injectable clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.benchmarks.common import card_info, er_graph, write_bench_json
from repro_torch.core import engine
from repro_torch.core.axis import LocalAxis
from repro_torch.core.partition import partition_for_solver
from repro_torch.core.qaoa import pad_subgraph_arrays
from repro_torch.device import resolve_device
from repro_torch.kernels import cutbatch, cutvals, fused_layer, mixer, ops, phase, tuning
from repro_torch.kernels.fused_layer import TILE_AMPS
from repro_torch.obs.clock import default_clock
from repro_torch.roofline.analysis import (DEFAULT_CARD, achieved_fraction,
                                           kernel_bound_s, peaks_for)

SUITE = "kernel_autotune"
OUT_PATH = Path(__file__).resolve().parents[3] / "build" / "autotune" / f"{SUITE}.json"
GROUP = 7  # qubits per mixer group, as the solve's default


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the sweep runs on: ``graph`` (n, p, seed) cut into subgraphs of
    ``n`` qubits gives the state ops' batch and cut values; cut at ``at_n``
    qubits, its largest subgraphs (padded to ``at_n``) over ``at_d`` shards
    give ``cutvals_at``'s edge rows and index table; each ``dense`` entry (B, V, p, seed) is one
    ``cut_batch_dense`` shape on G(V, p, seed)."""

    graph: tuple = (400, 0.1, 0)
    n: int = 24
    at_n: int = 26
    at_d: int = 4
    dense: tuple = ((1 << 18, 400, 0.1, 0), (4096, 16000, 0.01, 0))


FULL = Shapes()
SMOKE = Shapes(graph=(40, 0.2, 0), n=10, at_n=10, at_d=4,
               dense=((64, 48, 0.2, 0), (32, 50, 0.2, 1)))


def _pow2_divisors(dim: int, lo: int = 1, hi: int | None = None):
    """Powers of two in [lo, hi] that divide ``dim``."""
    hi = dim if hi is None else min(hi, dim)
    out, t = [], lo
    while t <= hi:
        if dim % t == 0:
            out.append(t)
        t *= 2
    return out


def _row_tiles(r: int, k: int):
    """``row_tile`` candidates of a (B, R, 2^k) view: the default first."""
    tiles = _pow2_divisors(r, lo=max(1, 256 >> k), hi=TILE_AMPS >> k)
    return _dedup([{"row_tile": min(TILE_AMPS >> k, r)}]
                  + [{"row_tile": t} for t in reversed(tiles)])


def _dedup(cands):
    seen, out = set(), []
    for c in cands:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


class _Sweeper:
    """Times candidates on one device and collects rows and winners."""

    def __init__(self, dev, repeats: int, clock, check):
        self.dev = dev
        self.backend = tuning.backend_of(dev)
        self.repeats = repeats
        self.clock = clock
        self.check = check
        self.card, self.power_limit = card_info(dev)
        self.bound_card = (peaks_for(self.card)[0] if self.backend == "cuda"
                           else DEFAULT_CARD)
        self.rows, self.entries = [], {}

    def sweep(self, op, dim, call, candidates, flops, nbytes, shape, unit="f32"):
        """Time every candidate (the default first); one row per
        (op, bucket). ``check(op, cand, out, default_out)`` sees every
        non-default candidate's output beside the default's."""
        key = tuning.cache_key(op, dim, self.backend)
        results, default_out = [], None
        for cand in candidates:
            with tuning.using_overrides({key: cand}):
                out, t = tuning.measure(call, repeats=self.repeats,
                                        clock=self.clock)
            if default_out is None:
                default_out = out
            elif self.check is not None:
                self.check(op, cand, out, default_out)
            del out
            results.append((t, cand))
        del default_out
        default_s = results[0][0]
        tuned_s, best = min(results, key=lambda r: r[0])
        bucket = tuning.shape_bucket(dim)
        cfg_str = ";".join(f"{k}={v}" for k, v in sorted(best.items()))
        on_card = self.backend == "cuda"
        self.rows.append({
            "name": f"{SUITE}/{op}_{bucket}",
            "runtime_s": tuned_s,
            "op": op,
            "bucket": bucket,
            "shape": shape,
            "mode": self.backend,
            "card": self.card,
            "power_limit": self.power_limit,
            "default_s": default_s,
            "tuned_s": tuned_s,
            "speedup_vs_default": default_s / tuned_s if tuned_s else 1.0,
            "config": best,
            "default_config": candidates[0],
            "candidates": len(candidates),
            "flops": flops,
            "bytes_accessed": nbytes,
            "model_bound_s": kernel_bound_s(flops, nbytes, self.bound_card, unit),
            # a CPU time against the card's bound would be no device metric
            "achieved_frac": (achieved_fraction(flops, nbytes, tuned_s,
                                                self.bound_card, unit)
                              if on_card else None),
            "derived": f"{cfg_str};default_s={default_s:.3e};bucket={bucket}",
        })
        self.entries[key] = best


def _state(shapes: Shapes, dev):
    """Unit-norm random (B, 2^n) planes and the cut values of the graph's
    subgraphs at n qubits, B the number of subgraphs."""
    n = shapes.n
    part = partition_for_solver(er_graph(*shapes.graph), n)
    edges, weights, _ = pad_subgraph_arrays(part.subgraphs, n, device=dev)
    b = part.m
    gen = torch.Generator(device=dev).manual_seed(0)
    re = torch.randn((b, 2**n), generator=gen, device=dev)
    im = torch.randn((b, 2**n), generator=gen, device=dev)
    norm = torch.sqrt(torch.sum(re * re + im * im, dim=1, keepdim=True))
    re.div_(norm)
    im.div_(norm)
    del norm
    cutv = cutvals.cutvals(n, edges, weights)
    gamma = torch.rand((b,), generator=gen, device=dev) * 2 - 1
    beta = torch.rand((b,), generator=gen, device=dev) * 2 - 1
    return edges, weights, re, im, cutv, gamma, beta


def _sweep_state_ops(sw: _Sweeper, shapes: Shapes):
    dev, n = sw.dev, shapes.n
    edges, weights, re, im, cutv, gamma, beta = _state(shapes, dev)
    b, dim = re.shape
    amps = b * dim
    shape = f"({b}, 2^{n})"

    tiles = _pow2_divisors(dim, lo=min(1024, dim), hi=32768)
    sw.sweep("apply_phase", dim,
             lambda: phase.apply_phase(re, im, cutv, gamma),
             _dedup([{"tile": min(phase.TILE, dim)}]
                    + [{"tile": t} for t in tiles]),
             flops=7.0 * amps, nbytes=20.0 * amps, shape=shape)
    e_tiles = _pow2_divisors(dim, lo=min(4096, dim), hi=131072)
    sw.sweep("expectation", dim,
             lambda: phase.expectation(re, im, cutv),
             _dedup([{"tile": min(phase.default_expectation_tile(dim), dim)}]
                    + [{"tile": t} for t in e_tiles]),
             flops=4.0 * amps, nbytes=12.0 * amps, shape=shape)

    # the trailing group of `mixer.apply_mixer`, on the (B, R, 2^group) view
    k = min(GROUP, n)
    dk = 2**k
    r = dim // dk
    v3 = (b, r, dk)
    sw.sweep("mixer_matmul", r,
             lambda: mixer.mixer_group_trailing(re.view(v3), im.view(v3), beta, k),
             _row_tiles(r, k), flops=6.0 * k * amps, nbytes=16.0 * amps,
             shape=f"({b}, 2^{n - k}, 2^{k})")

    # the layer's passes on this device (`ops.passes_on`): the fused pass
    # on the low f qubits, keyed on the row's 2^n amplitudes, then the
    # strided groups by bucket (x·y = 2^(n-k), so one bucket holds the
    # groups of one k); one call runs every group of it
    f, strided = ops.passes_on(re, n, GROUP)
    rf = dim >> f
    vf = (b, rf, 2**f)
    sw.sweep("fused_layer", dim,
             lambda: fused_layer.fused_phase_mixer_group(
                 re.view(vf), im.view(vf), cutv.view(vf), gamma, beta, f),
             _row_tiles(rf, f), flops=(6.0 + 6.0 * f) * amps, nbytes=20.0 * amps,
             shape=f"({b}, 2^{n - f}, 2^{f})")
    buckets = {}
    for lo, kk in strided:
        buckets.setdefault(kk, []).append(lo)
    for kk, los in buckets.items():
        def groups(kk=kk, los=los):
            out = []
            for lo in los:
                v4 = (b, 2 ** (n - lo - kk), 2**kk, 2**lo)
                out += mixer.mixer_group_strided(re.view(v4), im.view(v4), beta, kk)
            return tuple(out)

        y_min = 2 ** los[0]
        t_cands = [mixer.STAGE_AMPS >> kk] + [
            t for t in reversed(_pow2_divisors(y_min, lo=max(1, 256 >> kk),
                                               hi=mixer.STAGE_AMPS >> kk))]
        sw.sweep("mixer_strided", 2 ** (n - kk), groups,
                 _dedup([{"tile_y": min(t, y_min)} for t in t_cands]),
                 flops=6.0 * kk * amps * len(los),
                 nbytes=16.0 * amps * len(los),
                 shape=f"({b}, 2^{n}) k={kk} lo_bit {'+'.join(map(str, los))}")

    # the strided kernel against the relayout path it replaced, both at the
    # default geometry, on the first mid-state group
    if n > GROUP:
        kk = min(GROUP, n - GROUP)
        rr = max(sw.repeats, 5)
        _, t_fused = tuning.measure(
            lambda: mixer.apply_mixer_bits(re, im, n, GROUP, kk, beta),
            repeats=rr, clock=sw.clock)
        _, t_unf = tuning.measure(
            lambda: mixer.apply_mixer_bits_relayout(re, im, n, GROUP, kk, beta),
            repeats=rr, clock=sw.clock)
        bucket = tuning.shape_bucket(dim)
        sw.rows.append({
            "name": f"{SUITE}/mixer_relayout_{bucket}",
            "runtime_s": t_fused,
            "op": "mixer_relayout",
            "bucket": bucket,
            "shape": f"({b}, 2^{n}) k={kk} lo_bit {GROUP}",
            "mode": sw.backend,
            "card": sw.card,
            "power_limit": sw.power_limit,
            "fused_s": t_fused,
            "unfused_s": t_unf,
            "relayout_speedup": t_unf / t_fused if t_fused else 1.0,
            "fused_ge_unfused": bool(t_fused <= t_unf),
            "derived": f"fused_s={t_fused:.3e};unfused_s={t_unf:.3e}",
        })
    del re, im, cutv

    # the fill kernel's adds: T_lo + T_hi, then one a set bit of lo (l / 2 on average)
    sw.sweep("cutvals", dim,
             lambda: cutvals.cutvals(n, edges, weights),
             _cutvals_candidates(), flops=amps * (1.0 + min(n, cutvals.LO_BITS) / 2),
             nbytes=4.0 * amps + 12.0 * weights.numel(), shape=shape)


def _cutvals_candidates():
    """States per block of the fill kernel, the default first."""
    return _dedup([{"tile_b": t} for t in (cutvals.TILE_B, 128, 256, 512, 2048)])


def _sweep_cutvals_at(sw: _Sweeper, shapes: Shapes):
    n, dev = shapes.at_n, sw.dev
    axis = LocalAxis(shapes.at_d)
    part = partition_for_solver(er_graph(*shapes.graph), n)
    subs = [g for g in part.subgraphs if g.n == max(part.sizes)]  # 15 at n = 26
    edges, weights, _ = pad_subgraph_arrays(subs, n, device=dev)
    idx = engine.index_tables(engine.ShardedLayout(n=n, axis=axis), dev)[0]
    m = idx.numel()
    real_edges = int((weights != 0).sum())
    cands = [{"tile_b": t} for t in (cutvals.AT_TILE_B, 256, 512, 2048)]
    sw.sweep("cutvals_at", m,
             lambda: cutvals.cutvals_at(idx, edges, weights, n_bits=n),
             _dedup(cands), flops=2.0 * m * real_edges,
             nbytes=4.0 * m + 4.0 * len(subs) * m + 12.0 * weights.numel(),
             shape=f"idx {tuple(idx.shape)} x {len(subs)} edge rows of {n} qubits")


def dense_inputs(b: int, v: int, p: float, seed: int, dev):
    """±1 spins (B, V) from ``seed``, G(V, p, seed)'s dense adjacency and
    its total weight, all on ``dev``."""
    g = er_graph(v, p, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spins = torch.randint(0, 2, (b, v), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.float32).mul_(2).sub_(1)
    return spins, g.dense_adjacency(dev), g.total_weight().to(dev)


def _sweep_cut_batch_dense(sw: _Sweeper, shapes: Shapes):
    for b, v, p, seed in shapes.dense:
        spins, adj, wtot = dense_inputs(b, v, p, seed, sw.dev)
        cands = [{"batch_tile": cutbatch.BATCH_TILE, "k_chunk": cutbatch.K_CHUNK}]
        cands += [{"batch_tile": bt, "k_chunk": kc}
                  for bt in cutbatch.BATCH_TILES for kc in cutbatch.K_CHUNKS]
        # unit weights: one nonzero bf16 plane, one product on the tensor cores
        sw.sweep("cut_batch_dense", v,
                 lambda: cutbatch.cut_batch_dense(spins, adj, wtot),
                 _dedup(cands), flops=2.0 * b * v * v,
                 nbytes=4.0 * (b * v + v * v + b),
                 shape=f"({b}, {v}) G({v}, {p}, seed {seed})", unit="bf16_tensor")
        del spins, adj


def sweep_all(device="cuda", shapes: Shapes = FULL, repeats: int = 3, *,
              clock=default_clock, check=None):
    """(rows, entries): one row per swept (op, bucket), the relayout row
    and the summary row; ``entries`` maps each cache key to its winner."""
    sw = _Sweeper(torch.device(device), repeats, clock, check)
    _sweep_state_ops(sw, shapes)
    _sweep_cutvals_at(sw, shapes)
    _sweep_cut_batch_dense(sw, shapes)

    swept = [r for r in sw.rows if "speedup_vs_default" in r]
    speedups = [r["speedup_vs_default"] for r in swept]
    mean = sum(speedups) / len(speedups)
    sw.rows.append({
        "name": f"{SUITE}/tuned_vs_default",
        "runtime_s": sum(r["tuned_s"] for r in swept),
        "mode": sw.backend,
        "card": sw.card,
        "power_limit": sw.power_limit,
        "ops_swept": len(swept),
        "tuned_ge_default": bool(all(s >= 1.0 for s in speedups)),
        "mean_speedup": mean,
        "max_speedup": max(speedups),
        "derived": f"ops={len(swept)};mean_speedup={mean:.3f}",
    })
    return sw.rows, sw.entries


def write_cache(entries, device, path=tuning.CACHE_PATH):
    """Write the winners as the committed table; refuses anything but
    entries from a sweep on the card."""
    bad = [k for k in entries if not k.endswith("|cuda")]
    if torch.device(device).type != "cuda" or bad or not entries:
        raise ValueError("the tuning table takes entries from a sweep on the "
                         f"card only (device {device}, non-cuda keys {bad})")
    card, limit = card_info(device)
    payload = {
        "version": 1,
        "generated_by": "python -m repro_torch.benchmarks.kernel_autotune --write-cache",
        "card": card,
        "power_limit": limit,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    tuning.invalidate_committed()
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the sweep) or cpu (checks the harness only)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and 1 repeat")
    ap.add_argument("--write", action="store_true", help="write the rows to --out")
    ap.add_argument("--out", default=str(OUT_PATH))
    ap.add_argument("--write-cache", action="store_true",
                    help="write src/repro_torch/kernels/tuning_cache.json")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.write_cache and dev.type != "cuda":
        ap.error("--write-cache takes a sweep on the card (--device cuda)")
    shapes = SMOKE if args.smoke else FULL
    repeats = 1 if args.smoke and args.repeats == 3 else args.repeats
    rows, entries = sweep_all(dev, shapes, repeats)
    for r in rows:
        extra = (f" speedup={r['speedup_vs_default']:.3f}x {r['config']}"
                 if "config" in r else "")
        print(f"{r['name']},{r['runtime_s'] * 1e6:.1f}us{extra}")
    if args.write:
        print("wrote", write_bench_json(args.out, SUITE, rows, dev))
    if args.write_cache:
        print("wrote", write_cache(entries, dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
