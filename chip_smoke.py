#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ParaQAOA on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. The
script builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs these phases, each printing one line, failing on the first fault:

1. card: nvidia-smi's name and power limit, torch/CUDA versions, build time;
2. every kernel against its plain PyTorch version at the shapes its path
   gives it, with times: the single-device solve's (B = 18 subgraphs,
   n = 24 qubits; the layer backward's ∂β over all 24 qubits), the sharded
   solve's (n = 26 over D = 4 shards), and the dense cut batch's (2^18 x
   400 and 4,096 x 16,000 spins); the redesigned cut kernels bitwise on
   integer inputs, within their stated tolerances on real ones, and their
   table pass, fills and split planes bitwise against the mirrors in
   ``kernels/ref.py``; ∂β within its stated tolerance, in at most two
   reads of the planes over n = 24 qubits (each read timed), bitwise
   repeatable, a row's bits the same alone and in the batch, no spill;
3. the autograd rules (kernel path, the ∂β kernel included) against
   plain-PyTorch autograd;
4. the full-width solve: G(400, 0.1) Max-Cut at N = 24 qubits, with each
   kernel's launch count held against the count the code predicts, and
   where one Adam step's time goes (4b);
5. the same port on the card and on the CPU (G(60, 0.3), N = 10);
6. linear terms (MIS) on the card and on the CPU;
7. the sharded solve at full width: the same graph, N = 24 and mesh
   ``model=4`` (all four shards on this card), 16 subgraphs of 25-26
   qubits, launch counts held against the prediction, then 3 warm reruns
   with the same cut;
8. the sharded solve against the flat solve at N = 26 on its partition;
9. the faithful and alternating swap schedules on one 26-qubit subgraph;
10. 5 sharded Adam steps against 5 flat ones on that subgraph;
11. chunk == 1 (n = 4, D = 4): the trailing-axis mixer on the path;
12. two NCCL ranks against one process, where there are two cards: the
    sharded statevector, and a solve over mesh ``data=2``;
13. the block-shape sweep (``repro_torch.benchmarks.kernel_autotune``) at
    full width, every candidate's output held against the default's, and
    the G(400, 0.1) solve with the swept table on and off;
14. the 1-flip refinement and local search on the card: phase 4's merged
    assignment refined for 200 steps (the CPU's flips, bitwise repeatable),
    and a real-weight G(400, 0.1) (bitwise repeatable, within 1e-5·Σ|w| of
    the CPU's value);
15. the paper's headline instance, G(16000, 0.01), through
    ``python -m repro_torch.examples.solve_16k --qubits 20``'s entry point:
    843 subgraphs of 19-20 qubits in one batch, launch counts held against
    the prediction, stage times, peak memory, the local-search reference,
    and GW with the approximation ratio; kernels #1-#4 and ∂β held against
    their plain versions at n = 20 first;
16. QAOA² (signed contracted graphs through ``cutvals``) on the card against
    the CPU, and at N = 24;
17. the brute-force oracles on the card: n = 22 equal to the CPU's, n = 26
    bounding the solve of the same instance;
18. a solve under a recording tracer, exported in both formats and
    validated, and the build ledger: one build event a CUDA source from
    phase 1, none on a warm solve after ``reset()``;
19. the data axis on this card: G(300, 0.1) at N = 24 over mesh ``data=4``
    against the single-device solve (bitwise candidates, the same cut and
    assignment, the striped merge engaged, launches as predicted), the
    ``single`` and ``striped`` merge policies, and ``data=2,model=4`` on
    phase 7's partition against phases 7 and 8;
20. the headline again through the example with ``--mesh data=4``
    (candidates and cut equal to phase 15's), and with ``--merge striped``;
21. the solve service (``repro_torch.service``) on the card: (a) the
    planner's prior, warm solves of G(1000, 0.02) and G(2000, 0.02)
    through the service's dispatch at seven knob tuples (T, p and N each
    over its range), and the per-dispatch and per-subgraph terms fitted on
    them, written to build/service/calibration.json with the card's name
    and power limit; (b) 48 requests of the 400-vertex class from 2
    tenants at N = 12, 128 slots a dispatch: kernels #1-#4, ∂β and ∂γ at those shapes
    against their plain versions, one terminal state a request, launches
    as predicted, every uncached cut and assignment equal to a solo
    `solve()`, cached replays equal to their entries, throughput, latency,
    stage spans and the card's idle share; (c) a dispatch (one CUDA graph
    a bucket) returns before its batch has run, with no stream sync, at
    T = 1 and at T = 30 behind a 300 ms spin; (d) the same requests over
    mesh ``data=4`` equal to (b); (e) two streamed requests; (f) a
    wall-clock soak with deadlines at half (b)'s throughput;
22. the LM serve path (``repro_torch.models``, ``repro_torch.serving``):
    (a) each of the ten LM archs at its reduced config, card against CPU
    (forward, prefill, 8 teacher-forced decode steps; MoE bitwise
    repeatable); (b) qwen1.5-0.5b and (c) mamba2-1.3b at published widths
    and depth through ``python -m repro_torch.launch.serve --full-size``'s
    entry point: generate = argmax(forward), that forward against the CPU's,
    prefill and decode times against a decode step's bound, tokens/s, peak
    memory; (d), last of all, one profiled decode step of (b);
23. the train path (``repro_torch.training``, ``repro_torch.launch.train``):
    (a) one train step of each family's reduced config (dense, MoE, SSM,
    hybrid, VLM, audio), card against CPU, gradients bitwise equal on a
    rerun on the card; (b) qwen1.5-0.5b and (c) mamba2-1.3b at published
    widths and depth through ``python -m repro_torch.launch.train``'s entry
    point, 20 steps of 8 x 128 tokens: step time against its bound,
    tokens/s, peak memory with remat off and ``batch_dots``, a falling loss;
    (d) qwen's 6 steps straight against 3, a crash and a resume, bitwise;
    (e), at the end with the other profiles, one profiled qwen step;
24. the dry-run and the LM sharding rules (``repro_torch.launch.dryrun``,
    ``launch.sharding``): (a) a subprocess traces qwen1.5-0.5b's train_4k,
    prefill_32k and decode_32k cells, mamba2-1.3b's long_500k and the
    sharded 30-qubit QAOA on the fake 16 x 16 world (fake tensors, CUDA
    never initialised): per device FLOPs against the model's, bytes,
    collectives and the three roofline terms on the H100 data sheet, and a
    column-parallel product counted at 1/16; (b) qwen1.5-0.5b and
    mamba2-1.3b at published widths in f32 placed by ``params_shardings``
    on a one-rank NCCL ``DeviceMesh`` (data=1, model=1): a 4 x 128 forward
    bitwise equal to the one-device forward, and ``reshard_state`` back to
    the card alone bitwise; (c) with two cards, the (1, 2) → (2, 1) re-mesh
    over NCCL, forwards within 1e-5;

Phases 21a-f, 22a-c, 23a-d and 24 run right after phase 1, before the first
profiler trace (21g); then one JSON line of per-kernel numbers (``launches`` from phase 4's
solve, ``service_launches`` from 21b's drain), the nvidia-smi line, and
``{"ok": true, ...}`` as the last line. It exits non-zero, printing no
result, where CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import copy
import json
import os
import re as re_mod
import statistics
import subprocess
import sys
import time

import numpy as np

B_MAIN, N_MAIN, GROUP = 18, 24, 7  # the main path: G(400, 0.1) at N = 24
# the headline: G(16000, 0.01) at N = 20, the largest budget whose whole
# batch fits the card (N = 21 would need ~1.9x the amplitudes)
V_16K, P_16K, N_16K, B_16K, ROWS_16K = 16_000, 0.01, 20, 843, 4
N_BF_EQUAL, N_BF_BOUND = 22, 26  # the oracle phase: card = CPU; bound on a solve
D_MESH, M_SHARDED = 4, 16  # the sharded path: mesh model=4, 16 subgraphs
# the data axis: G(300, 0.1) at N = 24 gives 14 subgraphs, so the exhaustive
# merge (2·2^14 rows) fits the beam cap and data=4 stripes it
V_DATA, P_DATA, M_DATA = 300, 0.1, 14
# the solve service (phase 21): the paper's 400-vertex class, a quarter of the
# requests relabelled repeats, from 2 tenants, no deadline (so the planner
# takes the widest tuple of the reference's grid: N = 12, its limit), 128
# slots a dispatch
SVC_LOAD, SVC_RANGE, SVC_P, SVC_REPEAT, SVC_TENANTS = 48, (100, 400), 0.1, 0.25, 2
SVC_SLOTS, SVC_QUBITS, SVC_KNOBS = 128, 12, (12, 4, 30, 512)  # knobs (N, K, T, W)
FULL_BEHIND_MS = 150.0  # 21c: the T = 30 dispatch behind a 300 ms spin returns sooner
CAL_SIZES, CAL_P = (1000, 2000), 0.02  # 21a: benchmarks/large_scale.py --distributed
# 21a's knobs: that bench's, then T, p and N each moved to both ends of
# the service's range, and K and W to the planner grid's values (they set
# the merge's two terms apart); dispatched SVC_SLOTS rows at a time, each
# stage the median of CAL_REPEAT timed solves
CAL_BASE = {"n_qubits": 10, "top_k": 1, "p_layers": 2, "opt_steps": 12, "beam_width": 64}
CAL_VARIED = (("opt_steps", (4, 30)), ("p_layers", (1, 3)), ("n_qubits", (8, 12)),
              ("top_k", (2, 4)), ("beam_width", (32, 128, 512)))
CAL_SLOTS, CAL_REPEAT = SVC_SLOTS, 3
CAL_DEADLINES = (0.05, 2.0)  # 21a's plans at n = 400, |E| = 8000
SOAK_LOAD = 60  # 21f: arrivals of the wall-clock soak
# the LM serve path (phase 22): 22a every family's reduced config, card
# against CPU on 2 x 16 tokens (a prefill of 8, then 8 teacher-forced decode
# steps); 22b-c the serve CLI's defaults at published widths and depth
LM_B, LM_S, LM_PROMPT = 2, 16, 8
LM_SERVE = ("qwen1.5-0.5b", "mamba2-1.3b")
LM_SERVE_ARGS = ("--full-size", "--batch", "4", "--prompt-len", "16", "--new-tokens", "32")
LM_ATOL, LM_RTOL = 1e-4, 1e-4  # logits, card against CPU, f32 at every width
# the train path (phase 23): 23a one step of each family's reduced config,
# card against CPU; 23b-c the train CLI at published widths (B = 8, S = 128,
# 20 steps), peaks with remat off and batch_dots at TRAIN_PEAK_SEQ; 23d crash
# and resume; 23e, with the other profiles at the end, one profiled step
TRAIN_FAMILIES = ("qwen1_5_0_5b", "moonshot_v1_16b_a3b", "mamba2_1_3b", "zamba2_2_7b",
                  "internvl2_2b", "whisper_medium")
TRAIN_B, TRAIN_S = 2, 32
LM_TRAIN = ("qwen1.5-0.5b", "mamba2-1.3b")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 20
# S of the remat off / batch_dots peaks: mamba2's activations without remat at
# S = 512 (~20 (B, S, 4096) f32 tensors a layer, 48 layers) would not fit
TRAIN_PEAK_SEQ = {"qwen1.5-0.5b": 512, "mamba2-1.3b": 128}
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4  # of each reference leaf's max |g|, as the CPU tests
# the dry-run and the sharding rules (phase 24): 24a's cells on the fake
# single-pod world, 24b's forwards at published widths on a one-rank mesh
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k"),
                ("qwen1.5-0.5b", "decode_32k"), ("mamba2-1.3b", "long_500k"))
DRYRUN_TAG = "chip_smoke"
DRYRUN_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
frac = dryrun.per_rank_fraction()
for arch, shape in json.loads(sys.argv[1]):
    dryrun.main(["--arch", arch, "--shape", shape, "--tag", sys.argv[2]])
dryrun.run_qaoa_dryrun(multi_pod=False, schedule="alternating", tag=sys.argv[2])
print(json.dumps({"per_rank_fraction": frac}))
"""
PLACE_ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b")
PLACE_BATCH, PLACE_SEQ = 4, 128
REMESH_ATOL = 1e-5  # 24c: the reference's re-mesh tolerance
CPU_BAND = 0.02  # of Σ|w|: the default-steps band of tests/test_torch_core.py
TIE_RTOL = 1e-6  # marginals this close count as a tie the last ulp may break

KERNEL_META = {
    "cutvals": ("src/repro_torch/kernels/csrc/cutvals.cu",
                "src/repro/kernels/cutvals.py:47"),
    "fused_phase_mixer_group": ("src/repro_torch/kernels/csrc/fused_layer.cu",
                                "src/repro/kernels/fused_layer.py:41"),
    "mixer_group_strided": ("src/repro_torch/kernels/csrc/mixer.cu",
                            "src/repro/kernels/mixer.py:115"),
    "expectation": ("src/repro_torch/kernels/csrc/phase.cu",
                    "src/repro/kernels/phase.py:70"),
    "cutvals_at": ("src/repro_torch/kernels/csrc/cutvals.cu",
                   "src/repro/kernels/cutvals.py:108"),
    "mixer_group_trailing": ("src/repro_torch/kernels/csrc/fused_layer.cu",
                             "src/repro/kernels/mixer.py:72"),
    "apply_phase": ("src/repro_torch/kernels/csrc/phase.cu",
                    "src/repro/kernels/phase.py:29"),
    "cut_batch_dense": ("src/repro_torch/kernels/csrc/cutbatch.cu",
                        "src/repro/kernels/cutbatch.py:28"),
    # no Pallas kernel: the jnp contraction XLA fuses in the layer's custom_vjp
    "beta_grad": ("src/repro_torch/kernels/csrc/betagrad.cu",
                  "src/repro/kernels/ops.py:291"),
    # no Pallas kernel: the phase rule's jnp.sum(cutv * t) in the custom_vjp
    "phase_grad": ("src/repro_torch/kernels/csrc/phase.cu",
                   "src/repro/kernels/ops.py:431"),
}
DENSE_CHECK_ROWS = 64  # rows also scored through the edge list


def spill_bytes(line: str) -> int:
    """Bytes of spill stores and loads on a ptxas ``-v`` line."""
    w = line.replace(",", " ").split()
    return sum(int(w[i - 1]) for i in range(1, len(w) - 1)
               if w[i] == "bytes" and w[i + 1] == "spill" and w[i - 1].isdigit())


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median of per-call CUDA-event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_step(torch, ops, qaoa_mod, edges, weights, cfg, solve_s) -> None:
    """Where the solve stage's time goes: one full-width Adam step (the
    forward pass and its backward) timed alone, then under torch.profiler
    with device time summed per kernel; busy / wall gives the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = cfg.n_qubits
    cutv = ops.cutvals(n, edges, weights)
    g0, b0 = qaoa_mod.linear_ramp_init(cfg.p_layers, cfg.ramp_delta, device=cutv.device)
    b = cutv.shape[0]

    def step():
        g = g0.expand(b, -1).clone().requires_grad_(True)
        bb = b0.expand(b, -1).clone().requires_grad_(True)
        loss = -qaoa_mod.qaoa_expectation((g, bb), cutv, n)
        return torch.autograd.grad(loss.sum(), (g, bb))

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    top = " | ".join(f"{name[:60]} {ms:.1f} ms x{count}" for ms, count, name in rows[:8])
    print(f"[4b where the time goes] one Adam step at full width: wall {wall_ms:.1f} ms "
          f"(x{cfg.opt_steps} steps = {wall_ms * cfg.opt_steps / 1e3:.2f} s of the "
          f"{solve_s:.2f} s solve stage) | kernels busy "
          + (f"{busy:.1f} ms of the profiled step: {top}" if rows
             else "not measured (the profiler saw no device events)"))
    del cutv
    torch.cuda.empty_cache()


def kernel_cutvals_at(torch, graph, dev, record, results) -> None:
    """``cutvals_at`` on both views of every 26-qubit subgraph of the
    sharded solve (phase 7): bitwise against its plain version without
    linear rows and with integer ones, within CUTVALS_AT_RTOL of each edge
    row's Σ|w| + Σ|h| with standard-normal ones (the table order is not the
    edge order), and bitwise against the table mirror there too; the table
    pass bitwise against `ref.cutvals_split_tables`. Timed on the layout-A
    view, the table pass alone beside it."""
    from repro_torch.core import engine, qaoa as qaoa_mod
    from repro_torch.core.axis import LocalAxis
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.kernels import cutvals as cutvals_mod, ref

    axis = LocalAxis(D_MESH)
    n = N_MAIN + axis.h
    part = partition_for_solver(graph, n)
    subs = [g for g in part.subgraphs if g.n == n]
    edges, weights, _ = qaoa_mod.pad_subgraph_arrays(subs, n, device=dev)
    lin_rng = np.random.default_rng(7)
    lin_real = torch.as_tensor(lin_rng.standard_normal((len(subs), n), dtype=np.float32),
                               device=dev)
    lin_int = torch.as_tensor(lin_rng.integers(-3, 4, (len(subs), n)).astype(np.float32),
                              device=dev)
    tables = engine.index_tables(engine.ShardedLayout(n=n, axis=axis), dev)
    line, err_max = [], 0.0
    for label, linear in (("no linear", None), ("integer linear rows", lin_int),
                          ("real linear rows", lin_real)):
        e2, w2 = (edges, weights) if linear is None else ref.append_linear_rows(
            edges, weights, linear)
        got_t = cutvals_mod.split_tables(edges, weights, n, linear)
        want_t = ref.cutvals_split_tables(e2, w2, n)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got_t, want_t)),
              f"cutvals_at table pass ({label}) differs from ref.cutvals_split_tables")
        tol = cutvals_mod.CUTVALS_AT_RTOL * w2.abs().sum(1)  # per edge row
        for view, idx in zip("AB", tables):
            got = cutvals_mod.cutvals_at(idx, edges, weights, linear, n_bits=n)
            want = ref.cutvals_at(idx, edges, weights, linear)
            torch.cuda.synchronize()
            err = (got - want).abs().view(len(subs), -1).amax(1)
            if linear is None or linear is lin_int:
                check(torch.equal(got, want), f"cutvals_at view {view} ({label}) differs "
                      f"from its plain version by {float(err.max())}")
            else:
                check(bool((err <= tol).all()), f"cutvals_at view {view} ({label}): "
                      f"max_abs_err {float(err.max())} above the tolerance "
                      f"{float(tol.min())}")
                mirror = ref.cutvals_at_split(idx, want_t)
                check(torch.equal(got, mirror), f"cutvals_at view {view} ({label}) "
                      "differs from ref.cutvals_at_split")
                err_max = max(err_max, float(err.max()))
                del mirror
            del got, want
        line.append(f"{label}: tables equal to the mirror, both views "
                    + ("bitwise equal" if linear is None or linear is lin_int else
                       f"within {err_max:.3g} (tol {float(tol.min()):.3g}) and bitwise "
                       "equal to ref.cutvals_at_split"))
        del got_t, want_t
    idx = tables[0]
    ms = time_ms(torch, lambda: cutvals_mod.cutvals_at(idx, edges, weights, n_bits=n), 10)
    table_ms = time_ms(torch, lambda: cutvals_mod.split_tables(edges, weights, n), 10)
    plain = time_ms(torch, lambda: ref.cutvals_at(idx, edges, weights), 2)
    out_elems = len(subs) * idx.numel()
    real_edges = int((weights != 0).sum())
    record("cutvals_at", err_max, ms, plain,
           bytes_=4 * idx.numel() + 4 * out_elems + 12 * weights.numel(),
           flops=2 * idx.numel() * real_edges)
    r = results["cutvals_at"]
    print(f"[2 kernel cutvals_at] n={n} D={D_MESH}: idx {tuple(idx.shape)} x "
          f"{len(subs)} subgraphs, E_pad={edges.shape[1]} ({real_edges} real edges), "
          f"l={cutvals_mod.LO_BITS} | " + " | ".join(line) + f" | kernel {ms:.3f} ms "
          f"(table pass alone {table_ms:.3f} ms), plain {plain:.1f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    del edges, weights, lin_real, lin_int, tables, idx
    torch.cuda.empty_cache()


def kernel_cut_batch_dense(torch, dev, peak_key, record, results) -> None:
    """``cut_batch_dense`` at the merge beam's width (2^18 seeded random
    ±1 assignments of G(400, 0.1)) and at G(16000, 0.01) with 4,096 rows:
    exactly against its plain version and, on the first rows, against the
    edge-list cut (±1 spins and unit weights sum to integers below 2^24);
    a real-weight adjacency (G(400, 0.1) times seeded uniform weights) at
    4,096 rows within CUT_BATCH_RTOL · Σ|A|. The split planes are held
    bitwise against `ref.split_bf16`, and their flags give the bound's
    plane count t. Timed beside cuBLAS (the same function as one f32
    product and its epilogue, TF32 off), which the port never calls."""
    from repro_torch.benchmarks.common import er_graph
    from repro_torch.benchmarks.kernel_autotune import FULL, dense_inputs
    from repro_torch.core.graph import cut_value_batch
    from repro_torch.kernels import _build, cutbatch, ref
    from repro_torch.roofline.analysis import kernel_bound_s

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 products")
    spills = [ln.strip() for ln in _build.ptxas_log("cutbatch").splitlines()
              if "spill" in ln]
    parts = []
    for b, v, p, seed in FULL.dense:
        spins, adj, wtot = dense_inputs(b, v, p, seed, dev)
        got = cutbatch.cut_batch_dense(spins, adj, wtot)
        want = ref.cut_batch_dense(spins, adj, wtot)
        rows = spins[:DENSE_CHECK_ROWS]
        edge_cut = cut_value_batch(er_graph(v, p, seed), ((rows + 1) / 2).to(torch.int32))
        planes, flags = cutbatch.split_planes(adj)
        want_planes = ref.split_bf16(adj)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"cut_batch_dense ({b}, {v}) differs from its "
              f"plain version by {err}")
        check(torch.equal(got[:DENSE_CHECK_ROWS], edge_cut),
              f"cut_batch_dense ({b}, {v}) differs from cut_value_batch")
        check(all(torch.equal(a, w) for a, w in zip(planes, want_planes)),
              f"cut_batch_dense ({b}, {v}): split planes differ from ref.split_bf16")
        t = int(flags.sum())
        check(flags.tolist() == [1, 0, 0], f"unit weights: plane flags {flags.tolist()}")
        del planes, want_planes
        ms = time_ms(torch, lambda: cutbatch.cut_batch_dense(spins, adj, wtot), 5)
        split_ms = time_ms(torch, lambda: cutbatch.split_planes(adj), 5)
        plain = time_ms(torch, lambda: ref.cut_batch_dense(spins, adj, wtot), 3)
        lib = time_ms(torch, lambda: (wtot - 0.5 * ((spins @ adj) * spins).sum(1)) * 0.5, 3)
        flops, bytes_ = 2 * b * v * v * t, 4 * (b * v + v * v + b)
        if "cut_batch_dense" not in results:  # the merge beam's shape
            record("cut_batch_dense", err, ms, plain, bytes_=bytes_, flops=flops,
                   library_ms=lib, unit="bf16_tensor")
        bound = kernel_bound_s(flops, bytes_, peak_key, "bf16_tensor") * 1e3
        f32_bound = kernel_bound_s(flops + 3 * b * v, bytes_, peak_key) * 1e3
        parts.append(f"({b}, {v}) G({v}, {p}): equal to the plain version and to "
                     f"cut_value_batch on {DENSE_CHECK_ROWS} rows, cut[0] "
                     f"{float(got[0]):.0f}, plane flags {flags.tolist()} (planes equal "
                     f"to ref.split_bf16) | kernel {ms:.3f} ms (split pass alone "
                     f"{split_ms:.3f} ms), plain {plain:.3f} ms, cuBLAS + epilogue "
                     f"{lib:.3f} ms, bound {bound:.3f} ms (bf16 tensor cores, t={t}; "
                     f"f32 bound {f32_bound:.3f} ms)")
        del spins, adj, wtot, got, want, edge_cut
        torch.cuda.empty_cache()
    # real weights: every plane nonzero, the tolerance instead of bits
    b, (v, p, seed) = 4096, FULL.dense[0][1:]
    spins, adj, wtot = dense_inputs(b, v, p, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    adj = adj * torch.rand(adj.shape, generator=gen, device=dev)
    adj = adj + adj.T
    wtot = adj.sum() / 2
    got = cutbatch.cut_batch_dense(spins, adj, wtot)
    want = ref.cut_batch_dense(spins, adj, wtot)
    flags = cutbatch.split_planes(adj)[1]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = cutbatch.CUT_BATCH_RTOL * float(adj.abs().sum())
    check(err <= tol, f"cut_batch_dense real weights ({b}, {v}): max_abs_err {err} > {tol}")
    ms = time_ms(torch, lambda: cutbatch.cut_batch_dense(spins, adj, wtot), 5)
    parts.append(f"real weights ({b}, {v}): max_abs_err {err:.3g} (tol {tol:.3g}), "
                 f"plane flags {flags.tolist()}, kernel {ms:.3f} ms")
    results["cut_batch_dense"]["max_abs_err"] = max(
        results["cut_batch_dense"]["max_abs_err"], err)
    del spins, adj, got, want
    torch.cuda.empty_cache()
    print("[2 kernel cut_batch_dense] " + " || ".join(parts)
          + f" || ptxas: {'; '.join(spills) or 'no spill lines'}")


def predicted_sharded_launches(ops, dist_mod, axis, sizes, p, opt_steps, dev):
    """Launches of one sharded solve, per kernel, from the code's own
    rules: per launch of `sharded_qaoa_batch` (a group of same-n subgraphs
    is split so its peak fits the card), 2 ``cutvals_at`` (layouts A and
    B, alternating schedule), 1 expectation, and per layer 1 fused +
    one strided per group above the first of the n - h local qubits, and
    the global-qubit mix: strided, or trailing where chunk == 1."""
    want = {k: 0 for k in ops.KERNELS}
    for n in sorted(set(sizes)):
        per = dist_mod.subgraphs_per_launch(n, p, opt_steps, axis, dev)
        launches = len(dist_mod.launch_slices(sizes.count(n), per))
        n_local = n - axis.h
        mix = "mixer_group_strided" if n_local > axis.h else "mixer_group_trailing"
        want["cutvals_at"] += 2 * launches
        want["expectation"] += launches
        want["fused_phase_mixer_group"] += p * launches
        want["mixer_group_strided"] += p * len(range(GROUP, n_local, GROUP)) * launches
        want[mix] += p * launches
    return want


def predicted_solve_launches(cfg) -> dict:
    """Launches of one single-device solve, per kernel, from the code's own
    rules: 1 ``cutvals``; per Adam step a forward and a backward of p
    layers, each 1 fused + one strided per group above the first, and 1
    expectation, p ∂β and p ∂γ; then the final evolve and expectation."""
    p, steps = cfg.p_layers, cfg.opt_steps
    groups_above = len(range(GROUP, cfg.n_qubits, GROUP))
    return {
        "cutvals": 1,
        "cutvals_at": 0,
        "fused_phase_mixer_group": steps * 2 * p + p,
        "mixer_group_strided": (steps * 2 * p + p) * groups_above,
        "mixer_group_trailing": 0,
        "expectation": steps + 1,
        "apply_phase": 0,
        "cut_batch_dense": 0,
        "beta_grad": steps * p,  # one a layer backward, p a step
        "phase_grad": steps * p,  # likewise
    }


def flat_marginal(torch, qaoa_mod, ops, sub, n, cfg, dev):
    """The flat solve's marginal of one subgraph at the ramp angles, over
    its real qubits (the pad qubits are the high bits)."""
    e, w, _ = qaoa_mod.pad_subgraph_arrays([sub], n, device=dev)
    g0, b0 = qaoa_mod.linear_ramp_init(cfg.p_layers, cfg.ramp_delta, device=dev)
    with torch.no_grad():
        re, im = qaoa_mod.qaoa_statevector(ops.cutvals(n, e, w), n, g0[None], b0[None])
        return (re * re + im * im)[0].view(-1, 2**sub.n).sum(0)


def sharded_solve_phases(torch, dev, graph) -> dict:
    """Phases 7-10; returns phase 7's launch counts, partition, cut and
    candidates, and phase 8's flat cut and the rows it ties."""
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import engine, qaoa as qaoa_mod
    from repro_torch.core.axis import LocalAxis
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.kernels import ops

    axis = LocalAxis(D_MESH)
    n_top = N_MAIN + axis.h
    cfg = ParaQAOAConfig(n_qubits=N_MAIN, top_k=2, p_layers=3, sharded_opt_steps=0)
    p = cfg.p_layers
    part = partition_for_solver(graph, n_top)
    check(part.m == M_SHARDED and min(part.sizes) > N_MAIN,
          f"sharded partition sizes {part.sizes}: expected {M_SHARDED} above {N_MAIN}")
    predicted = predicted_sharded_launches(ops, dist_mod, axis, list(part.sizes), p,
                                           0, dev)

    # ---- 7. the sharded solve through its entry point -------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = dist_mod.solve_distributed(graph, cfg, f"model={D_MESH}", device="cuda")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_w = float(graph.total_weight())
    extra = out.report.extra
    print(f"[7 sharded solve] G(400, 0.1, seed=0) maxcut N={N_MAIN} mesh "
          f"{extra['mesh']} ({extra['axis']}) K={cfg.top_k} p={p} sharded_opt_steps=0: "
          f"cut {out.cut_value:.1f} of total weight {total_w:.0f} | M={part.m} "
          f"sizes {dict(sorted((n, part.sizes.count(n)) for n in set(part.sizes)))}, "
          f"{extra['sharded_subproblems']} sharded, beam={extra['beam']} | "
          + " ".join(f"{k}={v:.3f}s" for k, v in out.timings.items())
          + f" | peak memory {peak_gb:.2f} GB | launches {counts} predicted {predicted}")
    check(extra["sharded_subproblems"] == M_SHARDED,
          f"{extra['sharded_subproblems']} subgraphs sharded, expected {M_SHARDED}")
    check(counts == predicted, f"launch counts {counts} != predicted {predicted}")
    path = ("cutvals_at", "fused_phase_mixer_group", "mixer_group_strided", "expectation")
    check(all(counts[k] > 0 for k in path), f"a kernel of the path never ran: {counts}")
    check(np.isfinite(out.cut_value) and out.cut_value > total_w / 2,
          f"cut {out.cut_value} not above half the weight")
    # the same solve again in this process: the first one above also pays
    # for first launches (module loading, allocation), which spread widely
    warm = []
    for _ in range(3):
        again = dist_mod.solve_distributed(graph, cfg, f"model={D_MESH}", device="cuda")
        check(abs(again.cut_value - out.cut_value) <= CPU_BAND * total_w,
              f"warm rerun cut {again.cut_value} vs {out.cut_value} outside "
              f"{CPU_BAND:.0%} of the weight")
        warm.append((again.timings, again.cut_value))
    print(f"[7 sharded solve, warm] 3 reruns in this process: solve_s "
          f"{[round(t['solve_s'], 4) for t, _ in warm]}, total_s "
          f"{[round(t['total_s'], 4) for t, _ in warm]}, cuts {[c for _, c in warm]} "
          f"(the first run above: solve_s {out.timings['solve_s']:.4f}, total_s "
          f"{out.timings['total_s']:.4f})")
    del again
    torch.cuda.empty_cache()
    profile_sharded(torch, dist_mod, qaoa_mod, part, n_top, axis, cfg, dev,
                    out.timings["solve_s"])

    # ---- 8. sharded = flat at the lifted budget, as check_solve_distributed --
    cfg_flat = ParaQAOAConfig(n_qubits=n_top, top_k=2, p_layers=3, opt_steps=0)
    torch.cuda.reset_peak_memory_stats()
    flat = solve(graph, cfg_flat, partition=part, device="cuda")
    flat_gb = torch.cuda.max_memory_allocated() / 1e9
    ties = []
    if flat.cut_value != out.cut_value:
        for row in range(part.m):
            a = {int(x) for x in out.candidates[row]}
            b = {int(x) for x in flat.candidates[row]}
            if a == b:
                continue
            marg = flat_marginal(torch, qaoa_mod, ops, part.subgraphs[row], n_top,
                                 cfg_flat, dev)
            kth = float(marg[list(b)].min())
            for c in a - b:
                check(abs(float(marg[c]) - kth) <= TIE_RTOL * kth,
                      f"row {row}: sharded candidate {c} (marginal {float(marg[c])}) "
                      f"is no tie for the flat K-th {kth}")
            ties.append(row)
            del marg
    print(f"[8 sharded = flat] the flat solve at N={n_top} on the same partition: cut "
          f"{flat.cut_value:.1f} vs sharded {out.cut_value:.1f} (rows whose candidates "
          f"differ by a tie within {TIE_RTOL:g}: {ties}) | flat solve_s "
          f"{flat.timings['solve_s']:.3f}s, peak memory {flat_gb:.2f} GB")
    phase8 = {"flat_cut": flat.cut_value, "ties": ties}
    del flat
    torch.cuda.empty_cache()

    # ---- 9. the two swap schedules on one 26-qubit subgraph -------------------
    sub = next(g for g in part.subgraphs if g.n == n_top)
    e1, w1, _ = qaoa_mod.pad_subgraph_arrays([sub], n_top, device=dev)
    g0, b0 = qaoa_mod.linear_ramp_init(p, cfg.ramp_delta, device=dev)
    runs = {}
    for sched in ("faithful", "alternating"):
        ax = LocalAxis(D_MESH)
        swaps = []
        plain_swap = ax.swap
        ax.swap = lambda x, chunk: (swaps.append(1), plain_swap(x, chunk))[1]
        ops.reset_launch_counts()
        res = dist_mod.sharded_qaoa(e1[0], w1[0], n_top, g0, b0, ax, top_k=cfg.top_k,
                                    schedule=sched)
        runs[sched] = (res, len(swaps) // 2, ops.launch_counts()["cutvals_at"])
    (fa, fa_swaps, fa_cut), (al, al_swaps, al_cut) = runs["faithful"], runs["alternating"]
    perr = float((fa.probs.sort().values - al.probs.sort().values).abs().max())
    check(perr <= 1e-6, f"schedules' top-K probabilities differ by {perr} > 1e-6")
    check((fa_swaps, al_swaps) == (2 * p, p), f"swaps {fa_swaps}, {al_swaps} != {2 * p}, {p}")
    check((fa_cut, al_cut) == (1, 2), f"cutvals_at launches {fa_cut}, {al_cut} != 1, 2")
    print(f"[9 schedules] n={n_top} D={D_MESH} p={p}: top-{cfg.top_k} probabilities "
          f"agree to {perr:.3g} (tol 1e-6), expectation faithful "
          f"{float(fa.expectation):.6f} alternating {float(al.expectation):.6f} | swaps "
          f"faithful {fa_swaps} (2p), alternating {al_swaps} (p) | cutvals_at launches: "
          f"faithful {fa_cut} (no layout-B view), alternating {al_cut}")

    # ---- 10. 5 sharded Adam steps against 5 flat ones --------------------------
    steps = 5
    layout = engine.ShardedLayout(n=n_top, axis=axis)
    cut = engine.cut_table(layout, e1, w1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs, bs = engine.sharded_ascent(layout, cut, g0[None], b0[None], steps,
                                   cfg.learning_rate)
    torch.cuda.synchronize()
    t_sharded = (time.perf_counter() - t0) / steps
    sharded_gb = torch.cuda.max_memory_allocated() / 1e9
    del cut
    cutv = ops.cutvals(n_top, e1, w1)
    qcfg = qaoa_mod.QAOAConfig(n_qubits=n_top, p_layers=p, opt_steps=steps,
                               learning_rate=cfg.learning_rate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gf, bf = qaoa_mod.optimize_params(cutv, n_top, qcfg)
    torch.cuda.synchronize()
    t_flat = (time.perf_counter() - t0) / steps
    del cutv
    err = max(float((gs - gf).abs().max()), float((bs - bf).abs().max()))
    check(err <= 1e-4, f"sharded ascent vs flat: max angle difference {err} > 1e-4")
    print(f"[10 sharded ascent] n={n_top} D={D_MESH} {steps} Adam steps: angles agree "
          f"with the flat ascent to {err:.3g} (tol 1e-4) | per step: sharded "
          f"{t_sharded * 1e3:.1f} ms (peak {sharded_gb:.2f} GB), flat "
          f"{t_flat * 1e3:.1f} ms | gammas {[round(x, 5) for x in gs[0].tolist()]}")
    torch.cuda.empty_cache()
    return {"counts": counts, "part": part, "cut": out.cut_value,
            "candidates": out.candidates, "predicted": predicted, **phase8}


def profile_sharded(torch, dist_mod, qaoa_mod, part, n, axis, cfg, dev, solve_s):
    """Where the sharded solve stage's time goes: the n = 26 group again,
    timed alone, then under torch.profiler with device time per kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    subs = [g for g in part.subgraphs if g.n == n]
    e, w, _ = qaoa_mod.pad_subgraph_arrays(subs, n, device=dev)
    g0, b0 = qaoa_mod.linear_ramp_init(cfg.p_layers, cfg.ramp_delta, device=dev)

    def run():
        return dist_mod.sharded_qaoa_batch(e, w, n, g0, b0, axis, top_k=cfg.top_k)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    top = " | ".join(f"{name[:60]} {ms:.1f} ms x{count}" for ms, count, name in rows[:8])
    print(f"[7b where the time goes] the {len(subs)} subgraphs of n={n} through "
          f"sharded_qaoa_batch: wall {wall_ms:.1f} ms (the whole solve stage took "
          f"{solve_s:.3f} s) | kernels busy "
          + (f"{busy:.1f} ms: {top}" if rows
             else "not measured (the profiler saw no device events)"))
    del e, w
    torch.cuda.empty_cache()


def chunk_one_phase(torch, dev) -> int:
    """Phase 11: n = 4 over D = 4 leaves chunk = 1, so the global-qubit mix
    is the trailing-axis kernel; held against the CPU. Returns its launches."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import engine, qaoa as qaoa_mod
    from repro_torch.core.axis import LocalAxis
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import ops

    n, p = 4, 3
    g = Graph.erdos_renyi(n, 0.7, seed=3)
    g0, b0 = qaoa_mod.linear_ramp_init(p, 0.75)
    predicted = predicted_sharded_launches(ops, dist_mod, LocalAxis(D_MESH), [n], p, 0,
                                           dev)
    ops.reset_launch_counts()
    card = dist_mod.sharded_qaoa(g.edges.to(dev), g.weights.to(dev), n, g0.to(dev),
                                 b0.to(dev), LocalAxis(D_MESH), top_k=4)
    counts = ops.launch_counts()
    check(counts == predicted, f"chunk == 1 launches {counts} != predicted {predicted}")
    check(counts["mixer_group_trailing"] > 0, "the trailing kernel never ran")
    cpu = dist_mod.sharded_qaoa(g.edges, g.weights, n, g0, b0, LocalAxis(D_MESH),
                                top_k=4)
    layout = engine.ShardedLayout(n=n, axis=LocalAxis(D_MESH))
    planes = []
    for d in (dev, "cpu"):
        cut = engine.cut_table(layout, g.edges[None].to(d), g.weights[None].to(d))
        with torch.no_grad():
            re, im, _ = engine.evolve(layout, cut, g0[None].to(d), b0[None].to(d))
        planes.append(torch.stack([re, im]).cpu())
    err = float((planes[0] - planes[1]).abs().max())
    exp_err = abs(float(card.expectation) - float(cpu.expectation))
    prob_err = float((card.probs.cpu() - cpu.probs).abs().max())
    check(err <= 1e-6 and exp_err <= 1e-5 and prob_err <= 1e-6,
          f"chunk == 1 card vs CPU: states {err}, expectation {exp_err}, top-4 "
          f"probabilities {prob_err}")
    print(f"[11 chunk == 1] n={n} D={D_MESH} (L=4, chunk=1): launches {counts} = "
          f"predicted | card vs CPU: states within {err:.3g} (tol 1e-6), top-4 "
          f"probabilities within {prob_err:.3g} (tol 1e-6), expectation within "
          f"{exp_err:.3g} (tol 1e-5)")
    return counts["mixer_group_trailing"]


def _nccl_inputs():
    """The NCCL phase's instance: 2 subgraphs of 20 qubits, seeded."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph

    subs = [Graph.erdos_renyi(20, 0.3, seed=s) for s in (11, 12)]
    e, w, _ = qaoa_mod.pad_subgraph_arrays(subs, 20)
    g0, b0 = qaoa_mod.linear_ramp_init(3, 0.75)
    return e, w, g0, b0


def _nccl_rank(rank: int, port: int, src: str, queue) -> None:
    """One rank of phase 12: a `ProcessGroupAxis` shard of every subgraph."""
    sys.path.insert(0, src)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    from repro_torch.core import engine
    from repro_torch.core.axis import ProcessGroupAxis
    from repro_torch.core.distributed import sharded_qaoa_batch

    axis = ProcessGroupAxis.from_env("cuda")
    e, w, g0, b0 = (t.cuda() for t in _nccl_inputs())
    layout = engine.ShardedLayout(n=20, axis=axis)
    cut = engine.cut_table(layout, e, w)
    with torch.no_grad():
        re, im, _ = engine.evolve(layout, cut, g0.expand(2, -1), b0.expand(2, -1))
    res = sharded_qaoa_batch(e, w, 20, g0, b0, axis, opt_steps=2)
    sol = _nccl_data_solve("data=2")
    queue.put((rank, re.cpu().numpy(), im.cpu().numpy(),
               *(x.cpu().numpy() for x in res),
               sol.cut_value, sol.assignment, sol.candidates,
               sol.report.extra["merge_shards"]))
    dist.barrier()
    dist.destroy_process_group()


def _nccl_data_solve(spec: str):
    """Phase 12's data-axis solve: G(60, 0.3, seed 1) at N = 10, 30 Adam
    steps, on mesh ``spec``."""
    from repro_torch.core import ParaQAOAConfig
    from repro_torch.core.distributed import solve_distributed
    from repro_torch.core.graph import Graph

    return solve_distributed(Graph.erdos_renyi(60, 0.3, seed=1),
                             ParaQAOAConfig(n_qubits=10), spec, device="cuda")


def nccl_phase(torch, root: str) -> None:
    """Phase 12: two NCCL ranks (`ProcessGroupAxis`) against `LocalAxis` on
    one card, where the machine has two cards."""
    if torch.cuda.device_count() < 2:
        print(f"[12 nccl] not run: {torch.cuda.device_count()} CUDA device(s) visible, "
              "the NCCL route needs 2 (tests/test_torch_sharded.py runs the same "
              "ProcessGroupAxis over gloo on the CPU)")
        return
    import socket

    import torch.multiprocessing as mp
    from repro_torch.core import engine
    from repro_torch.core.axis import LocalAxis
    from repro_torch.core.distributed import sharded_qaoa_batch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_nccl_rank, args=(port, os.path.join(root, "src"), queue),
                   nprocs=2, join=False)
    got = sorted((queue.get() for _ in range(2)), key=lambda r: r[0])
    while not ctx.join():
        pass
    axis = LocalAxis(2)
    e, w, g0, b0 = (t.cuda() for t in _nccl_inputs())
    layout = engine.ShardedLayout(n=20, axis=axis)
    cut = engine.cut_table(layout, e, w)
    with torch.no_grad():
        re, im, _ = engine.evolve(layout, cut, g0.expand(2, -1), b0.expand(2, -1))
    res = sharded_qaoa_batch(e, w, 20, g0, b0, axis, opt_steps=2)
    state_err = max(float(np.abs(r[1] - re[i::2].cpu().numpy()).max())
                    + float(np.abs(r[2] - im[i::2].cpu().numpy()).max())
                    for i, r in enumerate(got))
    res_err = max(float(np.abs(r[3 + f] - res[f].cpu().numpy()).max())
                  for r in got for f in range(1, 5))
    same_bits = all(np.array_equal(r[3], res.bitstrings.cpu().numpy()) for r in got)
    check(state_err <= 1e-6 and res_err <= 1e-6 and same_bits,
          f"NCCL vs LocalAxis: states {state_err}, results {res_err}, bits {same_bits}")
    local = _nccl_data_solve("data=2")
    for r in got:
        cut, assignment, candidates, shards = r[8:]
        check(cut == local.cut_value and np.array_equal(assignment, local.assignment)
              and np.array_equal(candidates, local.candidates) and shards == 2,
              f"rank {r[0]}: data=2 over NCCL cut {cut} ({shards} merge shards) vs "
              f"LocalAxis {local.cut_value}")
    print(f"[12 nccl] 2 ranks x 2 subgraphs of 20 qubits: states within {state_err:.3g}, "
          f"probabilities, expectations and 2-step angles within {res_err:.3g} "
          f"(tol 1e-6) of LocalAxis(2) on one card, candidates equal | mesh data=2 over "
          f"NCCL, G(60, 0.3) N=10: cut {local.cut_value:.0f}, assignment and candidates "
          f"equal to the one-process solve's on every rank, 2 merge shards")


# the built-in launch geometry of every swept (op, bucket) at full width:
# the sweep must time it first
DEFAULT_GEOMETRY = {
    "apply_phase|2^24": {"tile": 4096},
    "expectation|2^24": {"tile": 16384},
    "mixer_matmul|2^17": {"row_tile": 32},
    "fused_layer|2^17": {"row_tile": 32},
    "mixer_strided|2^17": {"tile_y": 32},
    "mixer_strided|2^21": {"tile_y": 512},
    "cutvals|2^24": {"tile_b": 1024},
    "cutvals_at|2^26": {"tile_b": 1024},
    "cut_batch_dense|2^9": {"batch_tile": 128, "k_chunk": 64},
    "cut_batch_dense|2^14": {"batch_tile": 128, "k_chunk": 64},
}


def tuning_phase(torch, dev, graph, peak_key, root) -> dict:
    """Phase 13: the sweep of ``repro_torch.benchmarks.kernel_autotune`` at
    full width, as its entry point runs it, with every candidate's output
    held against the default's (bitwise; the expectation, whose reduction
    order follows its tile, within 1e-6 relative); then the G(400, 0.1)
    solve with the swept table off and on, in turns (off, on, on, off).
    Returns the sweep's launch counts."""
    from repro_torch.benchmarks import kernel_autotune as ka
    from repro_torch.benchmarks.common import write_bench_json
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.kernels import ops, tuning

    checked = []

    def same(op, cand, out, default_out):
        outs = out if isinstance(out, tuple) else (out,)
        dflt = default_out if isinstance(default_out, tuple) else (default_out,)
        for a, b in zip(outs, dflt):
            if op == "expectation":
                ok = torch.allclose(a, b, rtol=1e-6, atol=0)
            else:
                ok = torch.equal(a, b)
            check(ok, f"{op} under {cand} differs from the default geometry's output "
                  f"by {float((a - b).abs().max())}")
        checked.append(op)

    repeats = 3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows, entries = ka.sweep_all(dev, ka.FULL, repeats, check=same)
    sweep_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    swept = [r for r in rows if "speedup_vs_default" in r]
    check({r["op"] for r in swept} == set(tuning.TUNABLE_OPS),
          f"swept ops {sorted({r['op'] for r in swept})}")
    for r in swept:
        key = f"{r['op']}|{r['bucket']}"
        check(r["default_config"] == DEFAULT_GEOMETRY.get(key),
              f"{key}: first candidate {r['default_config']} is not the built-in "
              f"geometry {DEFAULT_GEOMETRY.get(key)}")
        check(r["tuned_s"] <= r["default_s"], f"{key}: tuned {r['tuned_s']} > default")
        check(r["mode"] == "cuda" and bool(r["power_limit"]),
              f"{key}: row of mode {r['mode']}, power limit {r['power_limit']}")
    for op in ("apply_phase", "cut_batch_dense"):
        want = sum(r["candidates"] for r in swept if r["op"] == op) * (repeats + 1)
        check(counts[op] == want, f"{op}: {counts[op]} launches in the sweep, "
              f"predicted {want} (candidates x {repeats + 1})")
    out_dir = os.path.join(root, "build", "autotune")
    write_bench_json(os.path.join(out_dir, "chip_smoke_sweep.json"), ka.SUITE, rows, dev)
    with open(os.path.join(out_dir, "chip_smoke_table.json"), "w") as f:
        json.dump({"entries": entries}, f, indent=1)
    relayout = next(r for r in rows if r.get("op") == "mixer_relayout")
    print(f"[13 tuning] sweep of {len(swept)} (op, bucket) at full width in "
          f"{sweep_s:.1f} s, {len(checked)} non-default candidates equal to the "
          f"default's output | launches {counts} | relayout path "
          f"{relayout['unfused_s'] * 1e3:.3f} ms vs strided {relayout['fused_s'] * 1e3:.3f} ms")
    for r in swept:
        frac = r["achieved_frac"]
        print(f"[13 tuning] {r['op']} {r['bucket']} {r['shape']}: default "
              f"{r['default_config']} {r['default_s'] * 1e3:.3f} ms, tuned {r['config']} "
              f"{r['tuned_s'] * 1e3:.3f} ms (x{r['speedup_vs_default']:.3f}, "
              f"{r['candidates']} candidates), bound {r['model_bound_s'] * 1e3:.3f} ms, "
              f"achieved {frac:.3f} of the {peak_key} bound")

    # the solve of phase 4 with the swept table off and on, in turns
    cfg = ParaQAOAConfig(n_qubits=N_MAIN)
    runs = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        if label == "on":
            with tuning.using_overrides(entries):
                out = solve(graph, cfg, device="cuda")
        else:
            out = solve(graph, cfg, device="cuda")
        runs[label].append((out.timings["total_s"], out.cut_value, ops.launch_counts()))
    scale = float(graph.weights.abs().sum())
    (_, cut_off, c_off) = runs["off"][0]
    for label, rs in runs.items():
        for _, cut, c in rs:
            check(c == c_off, f"table {label}: launches {c} != untuned {c_off}")
            check(abs(cut - cut_off) <= CPU_BAND * scale,
                  f"table {label}: cut {cut} vs untuned {cut_off} outside "
                  f"{CPU_BAND:.0%} of sum|w| = {scale}")
    print(f"[13 tuned solve] G(400, 0.1, seed=0) N={N_MAIN}, in turns off, on, on, "
          f"off: total_s off {[round(t, 3) for t, _, _ in runs['off']]}, on "
          f"{[round(t, 3) for t, _, _ in runs['on']]} | cuts off "
          f"{[c for _, c, _ in runs['off']]}, on {[c for _, c, _ in runs['on']]} (band "
          f"{CPU_BAND:.0%} of sum|w| = {CPU_BAND * scale:.1f}) | launches equal")
    return counts


def refine_phase(torch, graph, merged) -> None:
    """Phase 14: `refine` of phase 4's merged assignment, 200 steps, on the
    card twice and on the CPU (unit weights: equal flips); then a
    real-weight G(400, 0.1), bitwise repeatable on the card and within
    1e-5·Σ|w| of the CPU's value; `local_search` on the card and the CPU."""
    from repro_torch.core.baselines.local_search import local_search, refine
    from repro_torch.core.graph import Graph

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    steps = 200
    (a1, v1), t_card = timed(lambda: refine(graph, merged, steps, device="cuda"))
    a2, v2 = refine(graph, merged, steps, device="cuda")
    (ac, vc), t_cpu = timed(lambda: refine(graph, merged, steps, device="cpu"))
    flips = int((a1 != merged).sum())
    check(np.array_equal(a1, a2) and v1 == v2, "refine is not bitwise repeatable on the card")
    check(np.array_equal(a1, ac) and v1 == vc,
          f"refine on the card ({v1}) differs from the CPU's ({vc}) on unit weights")
    gw = Graph.erdos_renyi_weighted(400, 0.1, seed=0)
    start = np.random.default_rng(14).integers(0, 2, 400).astype(np.int8)
    (b1, w1), t_real = timed(lambda: refine(gw, start, steps, device="cuda"))
    b2, w2 = refine(gw, start, steps, device="cuda")
    _, wc = refine(gw, start, steps, device="cpu")
    scale = float(gw.weights.abs().sum())
    check(np.array_equal(b1, b2) and w1 == w2,
          "refine on real weights is not bitwise repeatable on the card")
    check(abs(w1 - wc) <= 1e-5 * scale, f"real-weight refine: card {w1} vs CPU {wc} "
          f"beyond 1e-5 of sum|w| = {scale}")
    s_card, c_card, rep = local_search(graph, restarts=2, steps=steps, device="cuda")
    s_cpu, c_cpu, _ = local_search(graph, restarts=2, steps=steps, device="cpu")
    check(np.array_equal(s_card, s_cpu) and c_card == c_cpu,
          f"local_search card {c_card} vs CPU {c_cpu}")
    print(f"[14 refine] G(400, 0.1) phase 4's merged cut refined {steps} steps: "
          f"{flips} flips to {v1:.0f}, equal to the CPU's and bitwise repeatable | card "
          f"{t_card * 1e3:.1f} ms, CPU {t_cpu * 1e3:.1f} ms | real weights: {w1:.4f} "
          f"(CPU {wc:.4f}, tol {1e-5 * scale:.3g}), bitwise repeatable, card "
          f"{t_real * 1e3:.1f} ms | local_search (2 restarts x {steps}): {c_card:.0f}, "
          f"equal to the CPU's, card {rep.runtime_s:.3f} s")


def state_kernel_checks(torch, dev, edges, weights, n: int, seed: int) -> str:
    """Kernels #1-#4, ∂β and ∂γ at n qubits on the rows of ``edges`` /
    ``weights`` (unit weights), against their plain versions: `cutvals`
    bitwise; the fused group [0, 7) in both directions, the strided
    groups above it and the expectation on seeded unit-norm states; ∂β
    over all n qubits within its tolerance and repeatable; ∂γ within 1e-5
    of Σ|c·t| a row and repeatable."""
    from repro_torch.kernels import betagrad, fused_layer, mixer, ops, phase, ref

    b = edges.shape[0]
    cut = ops.cutvals(n, edges, weights)
    want = ref.cutvals(n, edges, weights)
    torch.cuda.synchronize()
    check(torch.equal(cut, want), f"cutvals at n = {n} differs from its plain version")
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    re, im = t(rng.standard_normal((b, 2**n))), t(rng.standard_normal((b, 2**n)))
    norm = torch.sqrt(torch.sum(re * re + im * im, dim=1, keepdim=True))
    re, im = re / norm, im / norm
    gamma, beta = t(rng.uniform(-1, 1, b)), t(rng.uniform(-1, 1, b))
    errs = []
    v3 = (b, 2**n // 2**GROUP, 2**GROUP)
    for reverse in (False, True):
        args = (re.view(v3), im.view(v3), cut.view(v3), gamma, beta, GROUP)
        got = fused_layer.fused_phase_mixer_group(*args, reverse=reverse)
        ref_ = fused_layer.fused_phase_mixer_group_plain(*args, reverse)
        errs.append(max(float((x - y).abs().max()) for x, y in zip(got, ref_)))
    groups = []
    for lo in range(GROUP, n, GROUP):  # the layer's groups above the first
        k = min(GROUP, n - lo)
        shape = (b, 2 ** (n - lo - k), 2**k, 2**lo)
        got = mixer.mixer_group_strided(re.view(shape), im.view(shape), beta, k)
        ref_ = ref.mixer_group(re.view(shape), im.view(shape), beta, k)
        errs.append(max(float((x - y).abs().max()) for x, y in zip(got, ref_)))
        groups.append(f"[{lo}, {lo + k})")
    torch.cuda.synchronize()
    check(max(errs) <= 1e-5, f"state kernels at n = {n}: max_abs_err {errs} > 1e-5")
    exp = phase.expectation(re, im, cut)
    exp_want = ref.expectation(re, im, cut)
    # of the largest |<cut>|: a row of a sparse subgraph may have no edge
    rel = float((exp - exp_want).abs().max() / exp_want.abs().max().clamp_min(1e-30))
    check(rel <= 1e-5, f"expectation at n = {n}: max rel err {rel} > 1e-5")
    d_re, d_im = t(rng.standard_normal((b, 2**n))), t(rng.standard_normal((b, 2**n)))
    bargs = (d_re, d_im, re, im, 0, n)
    got = betagrad.beta_grad(*bargs)
    tol = betagrad.tolerance(*bargs)
    err = (got - ref.beta_grad(*bargs)).abs()
    check(bool((err <= tol).all()), f"beta_grad at n = {n}: {err.tolist()} > {tol.tolist()}")
    check(torch.equal(got, betagrad.beta_grad(*bargs)), f"beta_grad at n = {n} not repeatable")
    pg = phase.phase_grad(re, im, d_re, d_im, cut)
    scale = torch.sum((cut * (im * d_re - re * d_im)).abs(), dim=-1).clamp_min(1e-30)
    pg_rel = float(((pg - ref.phase_grad(re, im, d_re, d_im, cut)).abs() / scale).max())
    check(pg_rel <= 1e-5, f"phase_grad at n = {n}: max err {pg_rel} of sum|c t| > 1e-5")
    check(torch.equal(pg, phase.phase_grad(re, im, d_re, d_im, cut)),
          f"phase_grad at n = {n} not repeatable")
    del re, im, d_re, d_im, cut, want, got, ref_, bargs, pg
    torch.cuda.empty_cache()
    return (f"n={n} on {b} rows: cutvals bitwise, fused (both directions) and strided "
            f"{', '.join(groups)} within {max(errs):.3g} (tol 1e-5), expectation "
            f"{rel:.3g} rel, beta_grad in reads {ref.beta_grad_launches(0, n)} within "
            f"{float(err.max()):.3g} (tol {float(tol.min()):.3g}), phase_grad "
            f"{pg_rel:.3g} of sum|c t|, both repeatable")


def headline_phase(torch, dev, peak_key) -> dict:
    """Phase 15: G(16000, 0.01, seed 0) through the 16k example's entry
    point at N = 20: the whole batch of 843 subgraphs in one program.
    Returns its cut, candidates, stage times, peak and predicted launches."""
    from repro_torch.core import ParaQAOAConfig
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.baselines import goemans_williamson
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.examples import solve_16k
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    graph = Graph.erdos_renyi(V_16K, P_16K, seed=0)
    gen_s = time.perf_counter() - t0
    part = partition_for_solver(graph, N_16K)
    check(part.m == B_16K and set(part.sizes) <= {N_16K - 1, N_16K},
          f"headline partition M={part.m}, sizes {sorted(set(part.sizes))}")
    edges, weights, _ = qaoa_mod.pad_subgraph_arrays(part.subgraphs[:ROWS_16K], N_16K,
                                                     device=dev)
    kernels_line = state_kernel_checks(torch, dev, edges, weights, N_16K, seed=20)
    del edges, weights
    print(f"[15 headline kernels] {kernels_line}")
    del part

    argv = ["--n", str(V_16K), "--p", str(P_16K), "--qubits", str(N_16K)]
    args = solve_16k.build_parser().parse_args(argv)
    cfg = ParaQAOAConfig(n_qubits=N_16K, top_k=args.k, p_layers=2,
                         opt_steps=args.opt_steps, beam_width=64,
                         refine_steps=args.refine)
    predicted = predicted_solve_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, ls_rep = solve_16k.main([*argv, "--device", "cuda"])
    counts = ops.launch_counts()
    main_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_w = float(graph.total_weight())
    check(counts == predicted, f"headline launch counts {counts} != predicted {predicted}")
    check(np.isfinite(out.cut_value) and out.cut_value > total_w / 2,
          f"headline cut {out.cut_value} not above half the weight {total_w}")
    check(out.partition.m == B_16K, f"the example partitioned into {out.partition.m}")
    torch.cuda.empty_cache()
    # GW's step: the reference's lr = 0.05 collapses every vector onto one
    # line once lr times the mean degree passes 2 (here 160, so 8): the
    # aligned state is then a fixed point of the projected step, and every
    # hyperplane cuts nothing. lr = 1 / mean degree keeps the step as the
    # reference's 0.05 is at a mean degree of 20
    _, gw_default, _ = goemans_williamson(graph, steps=250, rounds=64, device="cuda")
    lr = graph.n / (2.0 * total_w)
    _, gw_cut, gw_rep = goemans_williamson(graph, steps=250, rounds=64, lr=lr,
                                           device="cuda")
    check(np.isfinite(gw_cut) and gw_cut > total_w / 2, f"GW cut {gw_cut} (lr {lr})")
    print(f"[15 headline solve] G({V_16K}, {P_16K}, seed=0): {graph.n_edges} edges (generated "
          f"in {gen_s:.1f} s) | N={N_16K} M={out.partition.m} K={cfg.top_k} p=2 "
          f"steps={cfg.opt_steps} beam=64 refine={cfg.refine_steps} | cut "
          f"{out.cut_value:.0f} of total weight {total_w:.0f} | "
          + " ".join(f"{k}={v:.3f}s" for k, v in out.timings.items())
          + f" | peak memory {peak_gb:.2f} GB | launches {counts} = predicted | "
          f"local search (1 x 300): {ls_rep.cut_value:.0f} in {ls_rep.runtime_s:.3f} s | "
          f"GW (r={gw_rep.extra['rank']}, 250 steps, 64 rounds, lr {lr:.6f} = 1 / mean "
          f"degree): {gw_cut:.0f} in {gw_rep.runtime_s:.3f} s (at the default lr 0.05: "
          f"{gw_default:.0f}) | AR vs GW {out.cut_value / gw_cut:.4f}, local search "
          f"vs GW {ls_rep.cut_value / gw_cut:.4f} | the example's main() {main_s:.1f} s")
    profile_solve(torch, graph, cfg, out.cut_value)
    phase15 = {"cut": out.cut_value, "candidates": out.candidates,
               "timings": out.timings, "peak_gb": peak_gb, "predicted": predicted,
               "argv": argv}
    del graph, out
    torch.cuda.empty_cache()
    return phase15


def profile_solve(torch, graph, cfg, first_cut) -> None:
    """Phase 15b: the headline solve again in this process (warm), under
    torch.profiler: its stage times, and device time summed per kernel;
    busy / wall gives the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = solve(graph, cfg, device="cuda")
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(abs(again.cut_value - first_cut) <= CPU_BAND * float(graph.weights.abs().sum()),
          f"warm headline cut {again.cut_value} vs {first_cut}")
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    top = " | ".join(f"{name[:60]} {ms:.1f} ms x{count}" for ms, count, name in rows[:10])
    print(f"[15b where the time goes] the headline solve again (warm, profiled): cut "
          f"{again.cut_value:.0f}, " + " ".join(f"{k}={v:.3f}s" for k, v in again.timings.items())
          + f" | wall {wall_s:.3f} s | kernels busy "
          + (f"{busy:.1f} ms ({busy / 1e3 / wall_s:.1%} of the wall): {top}" if rows
             else "not measured (the profiler saw no device events)"))
    # the merge stage in its two halves, on the warm solve's own inputs:
    # the plan (host numpy, edges bucketed by level) and the scan (card)
    from repro_torch.core import merge as merge_mod
    from repro_torch.core import paraqaoa as para_mod

    t0 = time.perf_counter()
    plan, bw = para_mod.merge_inputs(again.partition, again.candidates, cfg,
                                     device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    merged = merge_mod.merge_scan(plan, bw)
    score = float(merged.cut_value)
    scan_s = time.perf_counter() - t0 - plan_s
    print(f"[15b merge split] build_merge_plan {plan_s:.3f} s (host), merge_scan "
          f"{scan_s:.3f} s over {again.partition.m} levels, beam {bw} (score {score:.0f})")
    del again, prof, plan, merged
    torch.cuda.empty_cache()


def qaoa2_phase(torch, dev, graph) -> None:
    """Phase 16: QAOA² on the card against the CPU on G(60, 0.3) at N = 10,
    at N = 24 on G(400, 0.1); `cutvals` on a signed contraction of that
    graph bitwise against its plain version."""
    import importlib

    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import connectivity_preserving_partition
    from repro_torch.kernels import ops, ref

    q2 = importlib.import_module("repro_torch.core.baselines.qaoa_in_qaoa")
    small = Graph.erdos_renyi(60, 0.3, seed=1)
    _, cut_g, rep_g = q2.qaoa_in_qaoa(small, n_qubits=10, device="cuda")
    _, cut_c, _ = q2.qaoa_in_qaoa(small, n_qubits=10, device="cpu")
    scale = float(small.weights.abs().sum())
    check(abs(cut_g - cut_c) <= CPU_BAND * scale,
          f"QAOA² card {cut_g} vs CPU {cut_c} outside {CPU_BAND:.0%} of sum|w| = {scale}")
    torch.cuda.synchronize()
    _, cut_24, rep_24 = q2.qaoa_in_qaoa(graph, n_qubits=N_MAIN, device="cuda")
    m = int(np.ceil(graph.n / (N_MAIN - 1)))
    part = connectivity_preserving_partition(graph, m)
    rng = np.random.default_rng(16)
    bits = [rng.integers(0, 2, s).astype(np.int8) for s in part.sizes]
    contracted, _ = q2._contract(graph, part.ranges, bits)
    check(float(contracted.weights.min()) < 0, "the contraction has no negative weight")
    e, w, _ = qaoa_mod.pad_subgraph_arrays([contracted], N_MAIN, device=dev)
    got = ops.cutvals(N_MAIN, e, w)
    check(torch.equal(got, ref.cutvals(N_MAIN, e, w)),
          "cutvals on the signed contraction differs from its plain version")
    print(f"[16 qaoa2] G(60, 0.3, seed=1) N=10: card {cut_g:.0f} ({rep_g.runtime_s:.3f} s), "
          f"CPU {cut_c:.0f} (band {CPU_BAND:.0%} of sum|w| = {CPU_BAND * scale:.1f}) | "
          f"G(400, 0.1, seed=0) N={N_MAIN}: {m} subgraphs + a {m}-node orientation, cut "
          f"{cut_24:.0f} in {rep_24.runtime_s:.3f} s | cutvals on a signed contraction "
          f"({contracted.n_edges} edges, weights {float(contracted.weights.min()):.0f} to "
          f"{float(contracted.weights.max()):.0f}) padded to n={N_MAIN}: bitwise equal")
    del got
    torch.cuda.empty_cache()


def oracle_phase(torch, dev) -> None:
    """Phase 17: `brute_force_maxcut` at n = 22 on the card equal to the
    CPU's; `brute_force_problem` at n = 26 on the card bounding the port's
    solve of the same instance (MIS of G(26, 0.3)) from above."""
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core.baselines import brute_force as bf
    from repro_torch.core.graph import Graph, Problem, independent_set_violations

    g_eq = Graph.erdos_renyi(N_BF_EQUAL, 0.3, seed=17)
    a_g, v_g, rep_g = bf.brute_force_maxcut(g_eq, device="cuda")
    a_c, v_c, rep_c = bf.brute_force_maxcut(g_eq, device="cpu")
    check(np.array_equal(a_g, a_c) and v_g == v_c,
          f"brute force n={N_BF_EQUAL}: card {v_g} vs CPU {v_c}")
    mis = Problem.mis(Graph.erdos_renyi(N_BF_BOUND, 0.3, seed=17))
    a26, opt, rep26 = bf.brute_force_problem(mis, device="cuda")
    check(independent_set_violations(mis.graph, a26) == 0, "the exact MIS has a conflict")
    out = solve(mis, ParaQAOAConfig(n_qubits=10, refine_steps=50), device="cuda")
    check(out.cut_value <= opt + 1e-4 * max(1.0, abs(opt)),
          f"the solve's value {out.cut_value} is above the exact optimum {opt}")
    print(f"[17 oracle] brute_force_maxcut G({N_BF_EQUAL}, 0.3): cut {v_g:.0f}, card equal "
          f"to the CPU (card {rep_g.runtime_s:.3f} s, CPU {rep_c.runtime_s:.3f} s) | "
          f"brute_force_problem MIS G({N_BF_BOUND}, 0.3) over 2^{N_BF_BOUND}: optimum {opt:.0f} "
          f"({rep26.runtime_s:.3f} s), the solve (N=10, refine 50) {out.cut_value:.0f} <= it")


def obs_phase(torch, dev, graph, root) -> None:
    """Phase 18: the G(400, 0.1) solve (N = 24, refine 200) under a
    recording tracer, exported as JSON lines and Chrome events and
    validated; the ledger's build events from phase 1, then none after
    ``reset()`` on the warm solve, whose dispatches are all ``cuda``."""
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.kernels import _build, ops
    from repro_torch.obs import get_ledger, validate
    from repro_torch.obs.trace import Tracer, use_tracer

    led = get_ledger()
    builds = [(e.name, round(e.duration_s, 3)) for e in led.builds]
    check([b[0] for b in builds] == list(_build.SOURCES),
          f"ledger build events {builds}, expected one a source of {_build.SOURCES}")
    led.reset()
    cfg = ParaQAOAConfig(n_qubits=N_MAIN, refine_steps=200)
    tracer = Tracer(record=True)
    ops.reset_launch_counts()
    with use_tracer(tracer):
        out = solve(graph, cfg, device="cuda")
    counts = ops.launch_counts()
    check(counts == predicted_solve_launches(cfg), f"traced solve launches {counts}")
    out_dir = os.path.join(root, "build", "obs")
    os.makedirs(out_dir, exist_ok=True)
    jsonl = tracer.export(os.path.join(out_dir, "chip_smoke_trace.jsonl"))
    chrome = tracer.export(os.path.join(out_dir, "chip_smoke_trace.json"), "chrome")
    with open(jsonl) as f:
        errs = validate.validate_trace_jsonl(f.read())
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    records = [{"span_id": e["args"]["span_id"], "parent_id": e["args"].get("parent_id"),
                "name": e["name"], "t0": e["ts"], "t1": e["ts"] + e["dur"],
                "attrs": e["args"]} for e in events]
    errs += validate.validate_trace_records(records)
    check(not errs, f"trace violations: {errs}")
    names = [s.name for s in tracer.spans]
    check(names == ["partition", "solve_pool", "merge", "refine", "solve"],
          f"span tree {names}")
    snap = led.snapshot()
    check(snap["builds"] == 0 and snap["compiles"] == 0,
          f"the warm solve recorded {snap['builds']} builds")
    check(all(k.endswith("[cuda]") for k in snap["op_traces"]),
          f"dispatches off the card: {snap['op_traces']}")
    print(f"[18 obs] G(400, 0.1) N={N_MAIN} refine 200 under a recording tracer: cut "
          f"{out.cut_value:.0f}, spans {names}, refine_s {out.timings['refine_s']:.3f}, "
          f"JSON lines and Chrome exports valid ({len(events)} events) | ledger: phase 1's "
          f"build events {builds}; after reset() the warm solve recorded 0 builds, "
          f"0 compiles, dispatches {snap['op_traces']}")


def timed_solve(torch, fn):
    """``fn()`` from launch counts and the peak reset to zero; returns its
    output, its launch counts and its peak in GB."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    return out, counts, torch.cuda.max_memory_allocated() / 1e9


def stage_line(out) -> str:
    return " ".join(f"{k}={v:.3f}s" for k, v in out.timings.items())


def data_axis_phase(torch, dev, graph400, phase7) -> None:
    """Phase 19: the data axis on one card (every shard a `LocalAxis` row
    block). G(300, 0.1) at N = 24, K = 2: ``solve_distributed`` over
    ``data=4`` against `solve` on the same partition (bitwise candidates,
    the same cut and assignment, the striped merge engaged, launches equal
    to the prediction), the ``single`` and ``striped`` merge policies on
    the same instance; then ``data=2,model=4`` at opt_steps=0 on phase 7's
    partition against phase 7's ``model=4`` solve (bitwise candidates, the
    same cut) and phase 8's flat solve at N = 26 (the same cut up to the
    rows phase 8 found tied)."""
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import partition_for_solver

    graph = Graph.erdos_renyi(V_DATA, P_DATA, seed=0)
    part = partition_for_solver(graph, N_MAIN)
    check(part.m == M_DATA and max(part.sizes) <= N_MAIN,
          f"data-axis partition M={part.m}, sizes {sorted(set(part.sizes))}")
    cfg = ParaQAOAConfig(n_qubits=N_MAIN, top_k=2)
    predicted = predicted_solve_launches(cfg)
    single, c_single, gb_single = timed_solve(
        torch, lambda: solve(graph, cfg, partition=part, device="cuda"))
    check(c_single == predicted, f"single solve launches {c_single} != {predicted}")
    runs = {}
    for mode in ("auto", "single", "striped"):
        out, counts, gb = timed_solve(torch, lambda: dist_mod.solve_distributed(
            graph, cfg, f"data={D_MESH}", partition=part, merge_mode=mode,
            device="cuda"))
        check(counts == predicted, f"data={D_MESH} {mode}: launches {counts} != {predicted}")
        check(np.array_equal(out.candidates, single.candidates),
              f"data={D_MESH} {mode}: candidates differ from the single solve's in rows "
              f"{np.nonzero((out.candidates != single.candidates).any(1))[0].tolist()}")
        runs[mode] = (out, gb)
    auto, _ = runs["auto"]
    extra = auto.report.extra
    check(extra["merge_shards"] == D_MESH, f"auto merged on {extra['merge_shards']} shards")
    check(auto.cut_value == single.cut_value
          and np.array_equal(auto.assignment, single.assignment),
          f"data={D_MESH} cut {auto.cut_value} vs single {single.cut_value}")
    check(runs["single"][0].report.extra["merge_shards"] == 1, "single merged striped")
    total_w = float(graph.total_weight())
    print(f"[19 data axis] G({V_DATA}, {P_DATA}, seed=0) N={N_MAIN} K=2 p=3 steps=30, "
          f"M={part.m} (sizes {sorted(set(part.sizes))}), beam {extra['beam']}: mesh "
          f"data={D_MESH} ({extra['axis']}) candidates bitwise equal to solve()'s, cut "
          f"{auto.cut_value:.0f} = {single.cut_value:.0f} of {total_w:.0f}, assignment "
          f"equal, launches {c_single} = predicted | single solve: {stage_line(single)}, "
          f"peak {gb_single:.2f} GB | "
          + " | ".join(f"merge {m}: {o.report.extra['merge_shards']} shards x "
                       f"{o.report.extra['merge_per_shard_beam']} rows, cut "
                       f"{o.cut_value:.0f}, {stage_line(o)}, peak {gb:.2f} GB"
                       for m, (o, gb) in runs.items()))
    del runs, auto, single
    torch.cuda.empty_cache()

    # data x model on phase 7's partition: the sharded subproblems once
    cfg0 = ParaQAOAConfig(n_qubits=N_MAIN, top_k=2, p_layers=3, opt_steps=0,
                          sharded_opt_steps=0)
    out, counts, gb = timed_solve(torch, lambda: dist_mod.solve_distributed(
        graph400, cfg0, f"data=2,model={D_MESH}", partition=phase7["part"],
        device="cuda"))
    extra = out.report.extra
    check(counts == phase7["predicted"],
          f"data=2,model={D_MESH} launches {counts} != {phase7['predicted']}")
    check(np.array_equal(out.candidates, phase7["candidates"])
          and out.cut_value == phase7["cut"],
          f"data=2,model={D_MESH} cut {out.cut_value} vs model={D_MESH} {phase7['cut']}")
    check(extra["merge_shards"] == 2, f"merged on {extra['merge_shards']} shards")
    check(out.cut_value == phase7["flat_cut"] or phase7["ties"],
          f"cut {out.cut_value} vs the flat N={N_MAIN + 2} {phase7['flat_cut']} with no tie")
    print(f"[19 data x model] G(400, 0.1) mesh data=2,model={D_MESH} ({extra['axis']}) "
          f"opt_steps=0 on phase 7's partition: {extra['sharded_subproblems']} sharded, "
          f"merge 2 shards x {extra['merge_per_shard_beam']} rows | cut {out.cut_value:.0f}, "
          f"candidates bitwise equal to model={D_MESH}'s (cut {phase7['cut']:.0f}); flat "
          f"N={N_MAIN + 2}: {phase7['flat_cut']:.0f} (rows tied in phase 8: "
          f"{phase7['ties']}) | launches = phase 7's | {stage_line(out)}, peak {gb:.2f} GB")
    del out
    torch.cuda.empty_cache()


def headline_data_phase(torch, phase15) -> None:
    """Phase 20: the headline through ``python -m repro_torch.examples.solve_16k
    --qubits 20 --mesh data=4``'s entry point (candidates and cut equal to
    phase 15's, launches equal to its prediction), then with ``--merge
    striped`` (the paper's independent workers; reported, not held)."""
    from repro_torch.examples import solve_16k

    argv = [*phase15["argv"], "--mesh", f"data={D_MESH}", "--device", "cuda"]
    lines = []
    for merge in ("auto", "striped"):
        (out, ls_rep), counts, gb = timed_solve(
            torch, lambda: solve_16k.main([*argv, "--merge", merge]))
        extra = out.report.extra
        check(counts == phase15["predicted"],
              f"headline data={D_MESH} {merge}: launches {counts} != {phase15['predicted']}")
        check(np.array_equal(out.candidates, phase15["candidates"]),
              f"headline data={D_MESH} {merge}: candidates differ from phase 15's")
        if merge == "auto":
            check(out.cut_value == phase15["cut"],
                  f"headline data={D_MESH} cut {out.cut_value} vs phase 15 {phase15['cut']}")
        lines.append(f"--merge {merge}: cut {out.cut_value:.0f}, merge "
                     f"{extra['merge_shards']} shards x {extra['merge_per_shard_beam']} "
                     f"rows, {stage_line(out)}, peak {gb:.2f} GB")
        del out
        torch.cuda.empty_cache()
    print(f"[20 headline data={D_MESH}] G({V_16K}, {P_16K}) N={N_16K} through the "
          f"example's entry point: candidates bitwise equal to phase 15's, launches = "
          f"predicted | " + " | ".join(lines) + f" | phase 15: cut {phase15['cut']:.0f}, "
          f"{' '.join(f'{k}={v:.3f}s' for k, v in phase15['timings'].items())}, peak "
          f"{phase15['peak_gb']:.2f} GB")


class EventBackend:
    """A service backend that records a CUDA event before and after each
    dispatch's launches, on the dispatch's stream: nothing waits on them."""

    def __init__(self, torch, inner):
        self.torch, self.inner, self.events = torch, inner, []

    def solve_batch(self, *args, **kw):
        start = self.torch.cuda.Event(enable_timing=True)
        start.record()
        res = self.inner.solve_batch(*args, **kw)
        end = self.torch.cuda.Event(enable_timing=True)
        end.record()
        self.events.append((start, end))
        return res

    def describe(self):
        return self.inner.describe()

    def prepare(self, buckets, rows: int) -> int:
        return self.inner.prepare(buckets, rows)

    def device_s(self) -> float:
        """The dispatches' device time: first launch to last, summed."""
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def nonneg_fit(cols, y):
    """Least squares y ≈ cols @ c with c >= 0, for two columns: where the
    free fit gives a coefficient below 0, it is 0 and the other is refit."""
    a = np.asarray(cols, dtype=np.float64).T
    y = np.asarray(y, dtype=np.float64)
    c = np.linalg.lstsq(a, y, rcond=None)[0]
    if (c >= 0).all():
        return [float(v) for v in c]
    best = None
    for keep in range(a.shape[1]):
        col = a[:, keep]
        v = max(float(col @ y / (col @ col)), 0.0)
        r = float(((y - v * col) ** 2).sum())
        if best is None or r < best[0]:
            best = (r, keep, v)
    out = [0.0] * a.shape[1]
    out[best[1]] = best[2]
    return out


def calibration_knobs() -> list:
    """21a's knob tuples: the reference bench's (N = 10, K = 1, T = 12,
    W = 64, p = 2), and each of T, p, N, K and W moved to each value of
    CAL_VARIED with the others at the base."""
    tuples = [dict(CAL_BASE)]
    for field, values in CAL_VARIED:
        tuples += [dict(CAL_BASE, **{field: v}) for v in values]
    return tuples


def calibration_row(torch, g, knobs: dict, backend) -> dict:
    """One solve of ``g`` at ``knobs`` as the service runs it: the partition,
    the subgraphs dispatched CAL_SLOTS rows at a time through the local
    backend (one CUDA graph a bucket) and harvested, then the merge; each
    stage timed on the host's clock, the card synchronised at its end."""
    from repro_torch.core import ParaQAOAConfig
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.paraqaoa import merge_candidates
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.service import edge_capacity

    cfg = ParaQAOAConfig(**knobs)
    qcfg = cfg.qaoa_config()
    nq = cfg.n_qubits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = partition_for_solver(g, nq)
    t1 = time.perf_counter()
    results = []
    for i in range(0, part.m, CAL_SLOTS):
        e, w, m = qaoa_mod.pad_subgraph_arrays(part.subgraphs[i:i + CAL_SLOTS], nq,
                                               e_pad=edge_capacity(nq), n_rows=CAL_SLOTS,
                                               device="cuda")
        results.append((backend.solve_batch(qcfg, e, w, m),
                        min(CAL_SLOTS, part.m - i)))
    bits = np.concatenate([r.bitstrings.cpu().numpy()[:rows] for r, rows in results])
    t2 = time.perf_counter()
    _, cut, _ = merge_candidates(part, bits, cfg, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"mode": "single", "n": g.n, "edges": g.n_edges, "m": part.m, "knobs": knobs,
            "dispatches": len(results), "cut": cut, "partition_s": t1 - t0,
            "solve_s": t2 - t1, "merge_s": t3 - t2, "runtime_s": t3 - t0}


def calibration_plans(model) -> dict:
    """The planner's plans at n = 400, |E| = 8000 on ``model``: for each of
    CAL_DEADLINES, and for the tightest deadline any tuple of the grid is
    predicted to meet (``"floor"``)."""
    from repro_torch.service import SLA, Planner

    planner = Planner(cost_model=model)
    floor = min(model.predict(400, 8000, kn).total_s for kn in planner.grid)
    return {d: planner.plan(400, 8000, SLA(deadline_s=d))
            for d in (*CAL_DEADLINES, floor)} | {"floor": floor}


def calibration_phase(torch, root: str, smi: str) -> str:
    """Phase 21a: the planner's prior from this card. G(1000, 0.02) and
    G(2000, 0.02) solved as the service solves them (`calibration_row`),
    each at the twelve knob tuples of `calibration_knobs` (T in 4-30, p in
    1-3, N in 8-12, K in 1-4, W in 32-512), once to warm (each bucket's
    graph is captured there), then CAL_REPEAT times, each stage's median
    kept: the ``single`` rows `CostModel.fit` reads, each with its knobs.
    The fixed terms are fitted on the same rows (non-negative least
    squares): ``c_dispatch`` from solve_s = c·M(T+1)p2^N +
    c_dispatch·dispatches, ``c_merge_base`` from merge_s = c·WK|E| +
    c_merge_base·M, with the slots a dispatch. Written with the card's name
    and power limit to build/service/calibration.json, whose copy beside
    ``service/planner.py`` is `Planner()`'s prior (`planner.load_prior`).
    Checks that the prior prices the solve (c_solve > 0), that predicted
    cost rises with T, p and N, and that the tightest deadline the grid can
    meet at n = 400, |E| = 8000 gets a lower T or p than a 2 s one; prints
    the plans, and whether the 0.05 s one is predicted to be met (the
    host's partition and merge set the grid's floor there, 32-46 ms on
    the hosts measured, and the top of the grid costs 2-3 ms more, so 0.05
    s binds no knob or, on a slow host, is missed)."""
    from repro_torch.core.graph import Graph
    from repro_torch.service import KnobTuple, make_backend
    from repro_torch.service.planner import load_prior

    backend = make_backend(None, "cuda")
    rows = []
    for n in CAL_SIZES:
        g = Graph.erdos_renyi(n, CAL_P, seed=0)
        for knobs in calibration_knobs():
            calibration_row(torch, g, knobs, backend)  # warm: captures the bucket
            runs = [calibration_row(torch, g, knobs, backend) for _ in range(CAL_REPEAT)]
            row = dict(runs[0], **{k: statistics.median(r[k] for r in runs)
                                   for k in ("partition_s", "solve_s", "merge_s",
                                             "runtime_s")})
            kn = "_".join(f"{k[0]}{v}" for k, v in knobs.items())
            rows.append({"name": f"calibration/single_n{n}/p{CAL_P}/{kn}", **row})
    amp = [r["m"] * (r["knobs"]["opt_steps"] + 1) * r["knobs"]["p_layers"]
           * 2 ** r["knobs"]["n_qubits"] for r in rows]
    _, c_dispatch = nonneg_fit([amp, [r["dispatches"] for r in rows]],
                               [r["solve_s"] for r in rows])
    _, c_merge_base = nonneg_fit(
        [[r["knobs"]["beam_width"] * r["knobs"]["top_k"] * r["edges"] for r in rows],
         [r["m"] for r in rows]], [r["merge_s"] for r in rows])
    fixed = {"c_dispatch": c_dispatch, "c_merge_base": c_merge_base,
             "batch_slots": CAL_SLOTS}
    payload = {"suite": "service_calibration",
               "source": "chip_smoke.py phase 21a: warm solves through the service's "
                         "dispatch (one CUDA graph a bucket) on the card, each stage the "
                         f"median of {CAL_REPEAT}",
               "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "knobs": CAL_BASE, "fixed": fixed, "rows": rows}
    path = os.path.join(root, "build", "service", "calibration.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    model = load_prior(path)
    check(model.c_solve > 0, f"{path}: the prior prices the solve at 0: {model}")
    base = KnobTuple(n_qubits=10, top_k=2, opt_steps=12, beam_width=128, p_layers=2)
    rises = {}
    for field, values in CAL_VARIED[:3]:
        a, b = (model.predict(400, 8000, base._replace(**{field: v})).solve_s
                for v in (values[0], values[-1]))
        check(b > a, f"predicted solve_s does not rise with {field}: {a} -> {b}")
        rises[field] = f"{a * 1e3:.2f} -> {b * 1e3:.2f} ms"
    plans = calibration_plans(model)
    tight, loose, floor = (plans[d] for d in (*CAL_DEADLINES, plans["floor"]))

    def lower(a, b):
        return (a.knobs.opt_steps, a.knobs.p_layers) != (b.knobs.opt_steps, b.knobs.p_layers) \
            and a.knobs.opt_steps <= b.knobs.opt_steps and a.knobs.p_layers <= b.knobs.p_layers

    check(lower(floor, loose), f"the tightest deadline {plans['floor']:.4f} s plans "
          f"{tuple(floor.knobs)}, not a lower T or p than {CAL_DEADLINES[1]} s's "
          f"{tuple(loose.knobs)}")
    print(f"[21a calibration] {smi} | {len(rows)} rows: G(n, {CAL_P}) n in {CAL_SIZES} x "
          f"{len(calibration_knobs())} knob tuples, {CAL_SLOTS} slots a dispatch, median of "
          f"{CAL_REPEAT} | "
          + " | ".join(f"n={r['n']} {r['name'].rsplit('/', 1)[1]}: M={r['m']} "
                       f"d={r['dispatches']} partition {r['partition_s']:.4f} solve "
                       f"{r['solve_s']:.4f} merge {r['merge_s']:.4f} s" for r in rows)
          + f" | fixed (fitted): c_dispatch {c_dispatch:.4g} s, c_merge_base "
          f"{c_merge_base:.4g} s | fit: c_partition {model.c_partition:.4g}, c_solve "
          f"{model.c_solve:.4g}, c_merge {model.c_merge:.4g} | predicted solve at n=400 "
          f"|E|=8000: {rises} | plans (N, K, T, W, p) at n=400 |E|=8000: "
          + ", ".join(f"{d:.4g} s -> {tuple(plans[d].knobs)} (predicted "
                      f"{plans[d].predicted.total_s:.4f} s)"
                      for d in (plans["floor"], *CAL_DEADLINES))
          + f"; {CAL_DEADLINES[0]} s is predicted to be {'met' if tight.meets_deadline else 'missed'}"
          f" and {'lowers' if lower(tight, loose) else 'keeps'} T and p | {path}")
    return path


def service_mix():
    """Phase 21's requests and their tenants, from seed 0."""
    from repro_torch.service.workload import request_mix, tenant_mix

    return (request_mix(SVC_LOAD, SVC_RANGE, SVC_P, SVC_REPEAT, seed=0),
            tenant_mix(SVC_LOAD, SVC_TENANTS, seed=0))


def run_service(torch, graphs, tenants, **kw):
    """Submit every request, drain, and wait for the card; returns (service,
    request ids, wall seconds). ``kw`` goes to `ServiceConfig`, except
    ``tracer`` and ``backend``, which go to `SolveService`."""
    from repro_torch.service import ServiceConfig, SolveService

    extra = {k: kw.pop(k) for k in ("tracer", "backend") if k in kw}
    cfg = dict(batch_slots=SVC_SLOTS, max_qubits=SVC_QUBITS, max_inflight=2,
               recalibrate=False, device="cuda")
    cfg.update(kw)
    svc = SolveService(ServiceConfig(**cfg), **extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [svc.submit(g, tenant=t) for g, t in zip(graphs, tenants)]
    svc.drain()
    torch.cuda.synchronize()
    return svc, rids, time.perf_counter() - t0


def service_phase(torch, dev, ops) -> dict:
    """Phase 21b: the service at full width. Kernels #1-#4, ∂β and ∂γ
    against their plain versions on the first 128 subgraphs as the
    scheduler packs them (N = 12, edges padded to 66); the fold of the pad
    qubits alone and in the batch; then 48 requests through `SolveService`
    with their launches counted from 0: one terminal state each, launches
    = the bucket's prediction x dispatches, every request not served from
    the cache equal to a solo `solve()` bit for bit, every cached replay
    equal to the entry it replays."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core import solve
    from repro_torch.core.graph import as_problem, problem_value
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import (KnobTuple, ServiceConfig, SolveService, edge_capacity,
                                     make_backend)
    from repro_torch.service import backend as backend_mod
    from repro_torch.service.canonical import canonical_key
    from repro_torch.service.workload import request_mix

    graphs, tenants = service_mix()
    subs = [s for g in graphs for s in partition_for_solver(g, SVC_QUBITS).subgraphs]
    subs = subs[:SVC_SLOTS]
    edges, weights, _ = qaoa_mod.pad_subgraph_arrays(
        subs, SVC_QUBITS, e_pad=edge_capacity(SVC_QUBITS), n_rows=SVC_SLOTS, device=dev)
    line = state_kernel_checks(torch, dev, edges, weights, SVC_QUBITS, seed=21)
    # the pad fold: a group's rows alone and among the batch's, bitwise; and
    # whether the plain torch.sum over the pad axis would have moved
    probs = torch.as_tensor(np.random.default_rng(22).random(
        (SVC_SLOTS, 2**SVC_QUBITS), dtype=np.float32), device=dev)
    rows, n_real = SVC_SLOTS // 3 + 1, SVC_QUBITS - 4  # 16 pad states a row
    folded = qaoa_mod.fold_pad_bits(probs, n_real)
    check(torch.equal(qaoa_mod.fold_pad_bits(probs[:rows], n_real), folded[:rows]),
          f"the pad fold of {rows} rows differs alone and in {SVC_SLOTS}")
    plain_all = probs.view(SVC_SLOTS, -1, 2**n_real).sum(1)
    plain_moves = not torch.equal(probs[:rows].view(rows, -1, 2**n_real).sum(1),
                                  plain_all[:rows])
    print(f"[21b service kernels] {line} | pad fold (n_real {n_real} of {SVC_QUBITS}): "
          f"rows [0, {rows}) alone bitwise equal to the batch's (the plain torch.sum's "
          f"bits {'move' if plain_moves else 'do not move'} with the row count here)")
    del edges, weights, probs, folded, plain_all
    torch.cuda.empty_cache()

    # the service's build, which captures every bucket of the planner's grid
    # (from none: 21a's are dropped), then a warm-up drain on another seed's
    # requests, then the measured one
    backend_mod.clear_graphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built = SolveService(ServiceConfig(batch_slots=SVC_SLOTS, max_qubits=SVC_QUBITS,
                                       device="cuda"))
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    n_graphs = backend_mod.graph_count()
    # a graph a bucket but for top_k, which the graph leaves out
    want = len({(q.n_qubits, q.opt_steps, q.p_layers, lin)
                for q, _, lin in built._grid_buckets()})
    check(n_graphs == want, f"the service's build captured {n_graphs} graphs of {want}")
    del built
    warm = request_mix(4, SVC_RANGE, SVC_P, 0.0, seed=1)
    run_service(torch, warm, ["t0"] * len(warm))
    tracer = Tracer(record=True)
    backend = EventBackend(torch, make_backend(None, "cuda"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    svc, rids, wall = run_service(torch, graphs, tenants, tracer=tracer, backend=backend)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(backend_mod.graph_count() == n_graphs, f"the drains captured "
          f"{backend_mod.graph_count() - n_graphs} graphs")
    st = svc.stats
    check(sorted(svc.results) == sorted(rids) and len(set(rids)) == SVC_LOAD
          and st.terminal == SVC_LOAD == st.completed,
          f"terminal states: {st.completed} completed, {st.shed} shed, {st.expired} "
          f"expired of {SVC_LOAD}")
    knobs = {svc.results[r].plan.knobs for r in rids}
    check(knobs == {KnobTuple(*SVC_KNOBS)}, f"planned knobs {knobs}")
    cfg = svc.results[rids[0]].plan.to_config()
    want = {k: v * st.dispatches for k, v in predicted_solve_launches(cfg).items()}
    check(counts == want, f"service launches {counts} != {want}")

    def spans(name):
        return sum(sp.duration_s for sp in tracer.spans if sp.name == name)

    solve_spans, device_s = spans("solve"), backend.device_s()
    admission_s = spans("admission") + spans("partition")

    solo_s, solo = 0.0, 0
    for g, r in zip(graphs, rids):
        res = svc.results[r]
        if res.cached:
            continue
        t0 = time.perf_counter()
        out = solve(g, res.plan.to_config(), device="cuda")
        solo_s += time.perf_counter() - t0
        solo += 1
        check(out.cut_value == res.cut_value
              and np.array_equal(out.assignment, res.assignment),
              f"request {r} (n={g.n}): service cut {res.cut_value} vs solo "
              f"{out.cut_value}, assignments "
              f"{'equal' if np.array_equal(out.assignment, res.assignment) else 'differ'}")
    first = {}
    for g, r in zip(graphs, rids):
        if not svc.results[r].cached:
            first.setdefault(canonical_key(g), svc.results[r])
    cached = [(g, svc.results[r]) for g, r in zip(graphs, rids) if svc.results[r].cached]
    for g, res in cached:
        src = first[canonical_key(g)]
        replayed = float(problem_value(as_problem(g), torch.as_tensor(res.assignment)))
        check(res.cut_value == src.cut_value == replayed,
              f"cached replay {res.cut_value} (re-scored {replayed}) vs entry {src.cut_value}")

    lat = st.latency
    print(f"[21b service] {SVC_LOAD} requests (G(n, {SVC_P}), n in {SVC_RANGE}, "
          f"{SVC_REPEAT:.0%} relabelled repeats, {SVC_TENANTS} tenants) at N={cfg.n_qubits} "
          f"K={cfg.top_k} T={cfg.opt_steps} W={cfg.beam_width}, {SVC_SLOTS} slots: "
          f"{wall:.3f} s, {SVC_LOAD / wall:.2f} req/s, p50 {lat.percentile(0.5):.3f} s, "
          f"p99 {lat.percentile(0.99):.3f} s | {st.dispatches} dispatches, fill "
          f"{st.fill_ratio:.4f}, {st.cache_served} from the cache, peak {peak_gb:.2f} GB | "
          f"spans: admission (plan, canonical form, cache, partition) {admission_s:.3f} s, "
          f"solve {solve_spans:.3f} s, merge {spans('merge'):.3f} s | launches "
          f"= predicted x {st.dispatches} | {solo} uncached requests equal to solo "
          f"solve() bit for bit (solo solves {solo_s:.3f} s in all), {len(cached)} "
          f"cached replays equal their entries")
    return {"svc": svc, "rids": rids, "graphs": graphs, "tenants": tenants,
            "counts": counts, "throughput": SVC_LOAD / wall, "wall": wall, "subs": subs,
            "cfg": cfg, "solve_spans": solve_spans, "device_s": device_s,
            "prepare_s": prepare_s, "n_graphs": n_graphs}


def service_dispatch(s21, cfg=None):
    """One dispatch of 21b's first 128 subgraphs as the scheduler makes it:
    padded on the host, copied up from pinned memory, solved by the local
    backend. ``cfg`` the `QAOAConfig` (default 21b's)."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.service import edge_capacity, make_backend

    e, w, m = qaoa_mod.pad_subgraph_arrays(
        s21["subs"], SVC_QUBITS, e_pad=edge_capacity(SVC_QUBITS), n_rows=SVC_SLOTS,
        device="cuda")
    return make_backend(None, "cuda").solve_batch(cfg or s21["cfg"].qaoa_config(),
                                                  e, w, m)


def dispatch_phase(torch, s21) -> None:
    """Phase 21c: a dispatch does not wait for the card. 128 rows padded and
    dispatched as the scheduler does it: first as it comes (its wall, its
    device time from first launch to last, the harvest's wait); then the
    same path at
    T = 1 behind a 300 ms spin kernel under ``set_sync_debug_mode("error")``:
    it must return with the spin still running and an event recorded after
    its last launch not complete (the loop body is the same at any T, so
    a host read anywhere on the path would show here). Then at T = 30
    behind the spin: 2,724 kernels eagerly, more than the card's launch
    queue holds, but one replay of the bucket's CUDA graph, so it must
    return within FULL_BEHIND_MS, its event pending, with the same
    candidates. Then 21b's ``solve`` spans against its dispatches'
    device time: at least half of it (a dispatch that waited for the card
    would leave the spans near 0)."""
    import dataclasses

    qcfg = s21["cfg"].qaoa_config()

    def dispatch(cfg=qcfg):
        return service_dispatch(s21, cfg)

    def spin(ms: float) -> None:
        torch.cuda._sleep(int(ms / ms_per_cycle))

    want = dispatch().bitstrings.cpu()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    res = dispatch()
    disp_s = time.perf_counter() - t0
    end.record()
    done_at_return = end.query()
    t0 = time.perf_counter()
    bits = res.bitstrings.cpu()
    wait_s = time.perf_counter() - t0
    check(torch.equal(bits, want), "a second dispatch's candidates differ")
    dev_ms = start.elapsed_time(end)

    cal = 10_000_000
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(cal)
    s1.record()
    s1.synchronize()
    ms_per_cycle = s0.elapsed_time(s1) / cal
    one = dataclasses.replace(qcfg, opt_steps=1)
    want_one = dispatch(one).bitstrings.cpu()
    spin_ms = 300.0
    spin(spin_ms)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        res = dispatch(one)
        behind_s = time.perf_counter() - t0
        ev = torch.cuda.Event()
        ev.record()
        pending = not ev.query()
    except RuntimeError as exc:
        fail(f"the dispatch synchronised with the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    bits = res.bitstrings.cpu()
    behind_wait_s = time.perf_counter() - t0
    check(pending and behind_s * 1e3 < spin_ms / 2,
          f"behind a {spin_ms:.0f} ms spin the T=1 dispatch took {behind_s * 1e3:.1f} ms "
          f"and its event was {'pending' if pending else 'complete'} at return")
    check(torch.equal(bits, want_one), "the dispatch behind the spin gave other candidates")
    torch.cuda.synchronize()
    spin(spin_ms)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        res = dispatch()
        full_behind_s = time.perf_counter() - t0
        ev = torch.cuda.Event()
        ev.record()
        full_pending = not ev.query()
    except RuntimeError as exc:
        fail(f"the T={qcfg.opt_steps} dispatch synchronised with the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(full_pending and full_behind_s * 1e3 < FULL_BEHIND_MS,
          f"behind a {spin_ms:.0f} ms spin the T={qcfg.opt_steps} dispatch took "
          f"{full_behind_s * 1e3:.1f} ms (limit {FULL_BEHIND_MS:.0f}) and its event was "
          f"{'pending' if full_pending else 'complete'} at return")
    check(torch.equal(res.bitstrings.cpu(), want), "T=30 behind the spin: other candidates")
    ratio = s21["solve_spans"] / s21["device_s"]
    check(ratio >= 0.5, f"solve spans {s21['solve_spans']:.3f} s < half the dispatches' "
          f"device time {s21['device_s']:.3f} s")
    print(f"[21c dispatch] {SVC_SLOTS} rows at N={SVC_QUBITS}, T={qcfg.opt_steps}: dispatch "
          f"(pad + launches) {disp_s * 1e3:.2f} ms wall, device "
          f"{dev_ms:.2f} ms first launch to last, event after it "
          f"{'complete' if done_at_return else 'pending'} at return, harvest wait "
          f"{wait_s * 1e3:.2f} ms | T=1 behind a {spin_ms:.0f} ms spin, sync debug mode "
          f"'error': returned in {behind_s * 1e3:.2f} ms with its event pending, harvest "
          f"waited {behind_wait_s * 1e3:.1f} ms, candidates equal | T={qcfg.opt_steps} "
          f"behind the spin (one CUDA graph): returned in {full_behind_s * 1e3:.1f} ms "
          f"(limit {FULL_BEHIND_MS:.0f}) with its event pending, candidates equal | 21b: "
          f"the service's build captured the planner grid's {s21['n_graphs']} buckets in "
          f"{s21['prepare_s']:.3f} s, and no dispatch of its drains captured | solve spans "
          f"{s21['solve_spans']:.3f} s = {ratio:.2f} x the dispatches' device time "
          f"{s21['device_s']:.3f} s (need >= 0.5)")


def mesh_service_phase(torch, s21) -> None:
    """Phase 21d: 21b's requests through the mesh backend, ``data=4`` on
    this card (`LocalAxis` row blocks): every cut and assignment equal to
    21b's, four devices described."""
    svc, rids, wall = run_service(torch, s21["graphs"], s21["tenants"], mesh="data=4")
    desc = svc.backend.describe()
    check(desc["devices"] == 4, f"mesh backend {desc}")
    for r, r0 in zip(rids, s21["rids"]):
        a, b = svc.results[r], s21["svc"].results[r0]
        check(a.cut_value == b.cut_value and a.cached == b.cached
              and np.array_equal(a.assignment, b.assignment),
              f"request {r}: data=4 cut {a.cut_value} vs local {b.cut_value}")
    print(f"[21d mesh backend] {desc}: {SVC_LOAD} requests in {wall:.3f} s "
          f"({SVC_LOAD / wall:.2f} req/s), {svc.stats.dispatches} dispatches; every cut "
          f"and assignment equal to 21b's")


def stream_phase(torch, s21) -> None:
    """Phase 21e: two streamed requests: one snapshot a merge level,
    best-known cuts that never fall, and a final assignment whose re-scored
    cut is the streamed best."""
    from repro_torch.core.graph import as_problem, problem_value
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.service import ServiceConfig, SolveService

    svc = SolveService(ServiceConfig(batch_slots=SVC_SLOTS, max_qubits=SVC_QUBITS,
                                     recalibrate=False, enable_cache=False,
                                     device="cuda"))
    graphs = s21["graphs"][:2]
    seen = {}
    rids = [svc.submit(g, stream=True,
                       on_update=lambda rid, lv, m, cut: seen.setdefault(rid, []).append(
                           (lv, m, cut)))
            for g in graphs]
    svc.drain()
    parts = []
    for g, r in zip(graphs, rids):
        res = svc.results[r]
        m = partition_for_solver(g, res.plan.knobs.n_qubits).m
        ups = seen[r]
        check([u[0] for u in ups] == list(range(1, m + 1)), f"request {r}: levels "
              f"{[u[0] for u in ups]} of {m}")
        cuts = [u[2] for u in ups]
        check(cuts == sorted(cuts), f"request {r}: best-known cuts fell: {cuts}")
        final = float(problem_value(as_problem(g), torch.as_tensor(res.assignment)))
        check(final == cuts[-1] == res.cut_value,
              f"request {r}: final {final} vs streamed {cuts[-1]}")
        parts.append(f"n={g.n}: {m} snapshots, cut {cuts[0]:.0f} -> {cuts[-1]:.0f}")
    print("[21e stream] " + " | ".join(parts) + " | never falling; the final "
          "assignment re-scores to the streamed best")


def soak_phase(torch, cal_path: str, throughput: float) -> None:
    """Phase 21f: the wall-clock SLA soak. ``arrival_trace(60, rate, (100,
    400), 0.1, seed=0)`` with deadlines (2.0, 8.0) s at half 21b's
    throughput, recalibration on, the prior from 21a: every request one
    terminal state; attainment, shed, expired and downgrade rates."""
    from collections import Counter

    from repro_torch.service import Planner, ServiceConfig, SolveService
    from repro_torch.service.planner import load_prior
    from repro_torch.service.workload import arrival_trace, run_soak_wall

    rate = throughput / 2
    trace = arrival_trace(SOAK_LOAD, rate, SVC_RANGE, SVC_P, seed=0)
    planner = Planner(cost_model=load_prior(cal_path),
                      max_qubits=SVC_QUBITS, batch_slots=SVC_SLOTS)
    svc = SolveService(ServiceConfig(batch_slots=SVC_SLOTS, max_qubits=SVC_QUBITS,
                                     max_inflight=2, recalibrate=True, device="cuda"),
                       planner=planner)
    rids, wall = run_soak_wall(svc, trace)
    torch.cuda.synchronize()
    st = svc.stats
    states = Counter(svc.results[r].status for r in rids)
    check(len(set(rids)) == SOAK_LOAD and sorted(svc.results) == sorted(rids)
          and st.terminal == SOAK_LOAD
          and set(states) <= {"completed", "shed", "expired"},
          f"soak terminal states {dict(states)}, stats terminal {st.terminal}")
    knobs = Counter(tuple(svc.results[r].plan.knobs[:4]) for r in rids
                    if svc.results[r].status == "completed")
    lat = st.latency
    print(f"[21f soak] {SOAK_LOAD} arrivals at {rate:.2f} req/s (half of 21b, bursts x4), "
          f"deadlines 2/8 s, recalibration on from 21a's prior: {wall:.3f} s | "
          f"attainment {st.attainment:.4f}, completed {st.completed}, shed "
          f"{st.shed / SOAK_LOAD:.4f}, expired {st.expired / SOAK_LOAD:.4f}, downgraded "
          f"{st.downgraded / SOAK_LOAD:.4f} ({st.downgrade_events} re-plans), p50 "
          f"{lat.percentile(0.5):.3f} s, p99 {lat.percentile(0.99):.3f} s | knobs (N, K, T, "
          f"W) served {dict(knobs)} | recalibration {svc.planner.calibration.as_dict()}, "
          f"c_solve {planner.base_model.c_solve:.4g} -> {svc.planner.cost_model.c_solve:.4g}")


def service_profile_phase(torch, s21) -> None:
    """Phase 21g, after every timed part of phase 21: 21b's drain again under
    torch.profiler for the card's idle share, and the kernels one dispatch
    launches; one dispatch's wall before and after (a profiler session
    leaves later launches slower in this process, so it runs last)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dispatch_wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        service_dispatch(s21).bitstrings.cpu()
        return time.perf_counter() - t0

    before = dispatch_wall()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again, rids, wall = run_service(torch, s21["graphs"], s21["tenants"])
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e6
    check(all(again.results[r].cut_value == s21["svc"].results[r0].cut_value
              for r, r0 in zip(rids, s21["rids"])), "the profiled drain's cuts differ")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        service_dispatch(s21).bitstrings.cpu()
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA)
    after = dispatch_wall()
    idle = (f"kernels busy {busy:.3f} s: idle {1 - busy / wall:.1%} of the profiled "
            f"drain ({wall:.3f} s), {1 - busy / s21['wall']:.1%} of 21b's unprofiled "
            f"drain ({s21['wall']:.3f} s)" if busy else
            "idle share not measured (the profiler saw no device events)")
    print(f"[21g service profile] {idle} | one dispatch: {kernels} kernels, wall "
          f"{before * 1e3:.1f} ms before the profiler sessions, {after * 1e3:.1f} ms after")


def lm_batch(torch, cfg, bsz: int, seq: int, seed: int) -> dict:
    """Tokens, and a VLM's patches or an audio model's frames, on the CPU."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (bsz, seq)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (bsz, cfg.frontend_seq, cfg.d_model), dtype=np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (bsz, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    return batch


def logits_err(torch, got, want) -> float:
    """max |got − want|, failing past LM_ATOL + LM_RTOL·|want|."""
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all()), "non-finite logits on the card")
    check(torch.allclose(got, want, atol=LM_ATOL, rtol=LM_RTOL),
          f"logits differ: max |card - CPU| {(got - want).abs().max().item():.3g}")
    return (got - want).abs().max().item()


def lm_families_phase(torch, dev) -> None:
    """Phase 22a: every LM family at its reduced config, one CPU init copied
    to the card: ``forward`` over 2 x 16 tokens, ``prefill`` of the first 8
    and 8 teacher-forced ``decode_step``s, card against CPU within
    LM_ATOL + LM_RTOL·|logit|; MoE's ``moe_apply`` twice on the card, bitwise
    equal."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    errs = {}
    with torch.inference_mode():
        for i, arch in enumerate(configs.lm_arch_ids()):
            cfg = configs.get_reduced(arch)
            model = build_model(cfg)
            host = model.init(i, device="cpu")
            card = copy.deepcopy(host).to(dev)
            batch = lm_batch(torch, cfg, LM_B, LM_S, seed=i)
            on = {k: v.to(dev) for k, v in batch.items()}
            err = logits_err(torch, model.forward(card, on)[0], model.forward(host, batch)[0])
            extra = cfg.frontend_seq if cfg.family == "vlm" else 0
            s_max = LM_S + extra
            cut = lambda b: {**b, "tokens": b["tokens"][:, :LM_PROMPT]}  # noqa: E731
            lc, sc = model.prefill(card, cut(on), s_max)
            lh, sh = model.prefill(host, cut(batch), s_max)
            err = max(err, logits_err(torch, lc, lh))
            for j in range(LM_PROMPT, LM_S):
                lc, sc = model.decode_step(card, on["tokens"][:, j], sc)
                lh, sh = model.decode_step(host, batch["tokens"][:, j], sh)
                err = max(err, logits_err(torch, lc, lh))
            note = ""
            if cfg.n_experts:
                x = torch.randn((LM_B, LM_S, cfg.d_model), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(i))
                blk = card.blocks[0].moe
                kw = dict(k=cfg.experts_per_token, capacity_factor=cfg.moe_capacity_factor,
                          dense_residual=cfg.moe_dense_residual)
                a, b = moe_mod.moe_apply(blk, x, **kw)[0], moe_mod.moe_apply(blk, x, **kw)[0]
                check(torch.equal(a, b), f"{arch}: moe_apply differs on a rerun")
                note = ", moe_apply bitwise repeatable"
            errs[cfg.name] = f"{err:.2e}{note}"
            del card
    torch.cuda.empty_cache()
    print(f"[22a lm families] {len(errs)} archs at their reduced configs, forward over "
          f"{LM_B}x{LM_S} tokens, prefill of {LM_PROMPT} and {LM_S - LM_PROMPT} "
          f"teacher-forced decode steps, card = CPU within atol {LM_ATOL} rtol {LM_RTOL}; "
          f"max |card - CPU| per arch: " + ", ".join(f"{k} {v}" for k, v in errs.items()))


def decode_bytes(cfg, params, bsz: int, prompt: int, new: int) -> tuple:
    """(weight bytes, mean state bytes a decode step must move): every
    parameter read once; each cache's positions up to the step's read and
    its new entry written, each SSM state and conv history read and
    written."""
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    f = 4  # f32 activations and caches
    lengths = [prompt + j for j in range(1, new)]  # positions decode step j attends
    state = 0.0
    kv_layers = (0 if cfg.family == "ssm" else
                 sum(k == "ssm_attn" for k in cfg.layer_kinds()) if cfg.family == "hybrid"
                 else cfg.n_layers)
    if kv_layers:
        per_pos = 2 * kv_layers * bsz * cfg.n_kv_heads * cfg.head_dim_ * f
        state += per_pos * (statistics.mean(lengths) + 1)
    if cfg.family in ("ssm", "hybrid"):
        h = cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
        conv = (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        state += 2 * cfg.n_layers * bsz * (h + conv) * f
    return weights, state


def lm_serve_phase(torch, arch: str, mem_bw: float, tag: str) -> dict:
    """Phases 22b-c: ``python -m repro_torch.launch.serve --arch <arch>
    --full-size --batch 4 --prompt-len 16 --new-tokens 32`` in this
    process, then its engine again, warm, on the same prompt (the same
    tokens). Every generated token must equal the argmax of one forward
    over prompt + generated tokens at its position wherever that
    position's top-2 margin exceeds 2·LM_ATOL, and that forward's logits
    must hold against a CPU forward of the same weights. Prints prefill
    and decode times (CUDA events), tokens/s, peak memory, and a decode
    step's bound: weights plus the state it moves over the card's rate.
    Prefill and decode steps must not synchronise with the card."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import LM

    argv = ["--arch", arch, *LM_SERVE_ARGS, "--device", "cuda"]
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases keep
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = serve.run(argv)
    cold_s = time.perf_counter() - t0
    engine, out = served.engine, served.tokens
    cold = engine.step_ms()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(served.batch)
    warm_s = time.perf_counter() - t0
    warm = engine.step_ms()
    warm_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.array_equal(again, out), f"{arch}: a warm rerun generated other tokens")
    model, cfg, params = engine.model, engine.model.cfg, engine.params
    bsz, new = out.shape
    prompt = served.batch["tokens"].shape[1]

    # nothing from prefill to the last decode step waits for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            logits, state = model.prefill(params, served.batch, prompt + 5)
            tok = logits[:, 0].argmax(-1)
            for _ in range(4):
                logits, state = model.decode_step(params, tok, state)
                tok = logits.argmax(-1)
    except RuntimeError as exc:
        fail(f"{arch}: prefill or a decode step synchronised with the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")

    # the invariant at full width: generate = argmax(forward)
    seq = torch.cat([served.batch["tokens"], torch.as_tensor(out, device="cuda")], dim=1)
    with torch.inference_mode():
        logits = model.forward(params, {**served.batch, "tokens": seq})[0]
        chose = logits[:, prompt - 1: prompt - 1 + new].float()
        top2 = torch.topk(chose, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1] > 2 * LM_ATOL).cpu().numpy()
        argmax = chose.argmax(-1).cpu().numpy()
        check(np.array_equal(argmax[clear], out[clear]),
              f"{arch}: {int((argmax[clear] != out[clear]).sum())} generated tokens "
              f"differ from argmax(forward) at clear margins")
        host = LM(cfg, device="cpu")
        host.load_state_dict(params.state_dict())
        t0 = time.perf_counter()
        want = model.forward(host, {k: v.cpu() for k, v in
                                    {**served.batch, "tokens": seq}.items()})[0]
        cpu_s = time.perf_counter() - t0
        err = logits_err(torch, logits, want)
    del host, want, logits, chose

    weights, state = decode_bytes(cfg, params, bsz, prompt, new)
    bound_ms = (weights + state) / mem_bw * 1e3
    dec = statistics.median(warm["decode_ms"])
    print(f"[{tag} lm serve] {cfg.name} at published widths and depth ({cfg.n_layers} "
          f"layers, d={cfg.d_model}, vocab {cfg.vocab_size}, {weights / 4e6:.1f} M params "
          f"in f32, {weights / 1e9:.3f} GB) through `python -m repro_torch.launch.serve "
          f"{' '.join(argv[:-2])}`: {bsz}x{new} tokens | cold run {cold_s:.3f} s (prefill "
          f"{cold['prefill_ms']:.3f} ms, decode median "
          f"{statistics.median(cold['decode_ms']):.3f} ms), warm generate {warm_s:.3f} s: "
          f"prefill {warm['prefill_ms']:.3f} ms, decode {dec:.3f} ms a step (median of "
          f"{len(warm['decode_ms'])}; min {min(warm['decode_ms']):.3f}, max "
          f"{max(warm['decode_ms']):.3f}), {bsz * new / warm_s:.1f} tokens/s | bound of a "
          f"decode step {bound_ms:.3f} ms (weights {weights / 1e9:.3f} GB + state "
          f"{state / 1e9:.3f} GB over {mem_bw / 1e12:.2f} TB/s): {bound_ms / dec:.3f} of it "
          f"| peak {peak_gb - held_gb:.2f} GB (cold run, init included), "
          f"{warm_gb - held_gb:.2f} GB (warm generate) above the {held_gb:.2f} GB earlier "
          f"phases hold | generate = argmax(forward) at {int(clear.sum())} of "
          f"{clear.size} positions (the rest within 2*{LM_ATOL} of a tie) | forward over "
          f"{bsz}x{prompt + new} card = CPU, max |diff| {err:.2e} (CPU forward "
          f"{cpu_s:.2f} s) | prefill and 4 decode steps under "
          f"set_sync_debug_mode('error'): no sync")
    return {"engine": engine, "batch": served.batch, "decode_ms": dec}


def lm_profile_phase(torch, s22) -> None:
    """Phase 22d, after every timed part of the smoke: one profiled decode
    step of 22b's model: the kernels it launches, the card's busy time
    against the step's wall, so the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = s22["engine"]
    model, params, batch = engine.model, engine.params, s22["batch"]
    prompt = batch["tokens"].shape[1]
    with torch.inference_mode():
        logits, state = model.prefill(params, batch, prompt + 8)
        tok = logits[:, 0].argmax(-1)
        for _ in range(2):  # warm
            logits, state = model.decode_step(params, tok, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, state = model.decode_step(params, tok, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    kernels = sum(ev.count for ev in evs)
    busy = sum(ev.self_device_time_total for ev in evs) / 1e3
    idle = (f"kernels busy {busy:.3f} ms of the step's {wall * 1e3:.3f} ms wall: idle "
            f"{1 - busy / (wall * 1e3):.1%}, {1 - busy / s22['decode_ms']:.1%} of 22b's "
            f"unprofiled median step" if busy else
            "idle share not measured (the profiler saw no device events)")
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:3]
    print(f"[22d lm decode profile] {model.cfg.name}, one decode step at B="
          f"{batch['tokens'].shape[0]}: {kernels} kernels, {idle} ("
          f"{s22['decode_ms']:.3f} ms) | most device time: " + ", ".join(
              f"{ev.key[:40]} {ev.self_device_time_total / 1e3:.3f} ms x{ev.count}"
              for ev in top))


def train_families_phase(torch, dev) -> None:
    """Phase 23a: one train step of each family at its reduced config, one
    CPU init copied to the card, the same batch: the loss within 1e-5
    relative and every gradient within GRAD_ATOL + GRAD_RTOL·max|g| of its
    reference leaf, card against CPU, under remat ``batch_dots``; the card's
    gradients bitwise equal on a rerun and with remat off; then the whole
    step (AdamW included) on the card."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import reference_leaf
    from repro_torch.training import data
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as TT

    tcfg = TT.TrainConfig(adamw=opt.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                                                total_steps=100))
    errs = {}
    for i, arch in enumerate(TRAIN_FAMILIES):
        cfg = configs.get_reduced(arch)
        model = build_model(cfg)
        host = model.init(i, device="cpu")
        card = copy.deepcopy(host).to(dev)
        batch = data.synthetic_batch(cfg, data.DataConfig(seed=i, batch=TRAIN_B,
                                                          seq=TRAIN_S), 0)
        on = {k: v.to(dev) for k, v in batch.items()}
        lc, _, gc = TT.value_and_grad(card, on, model, tcfg)
        lh, _, gh = TT.value_and_grad(host, batch, model, tcfg)
        check(abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh)),
              f"{arch}: loss card {float(lc)} CPU {float(lh)}")
        top = {}
        for n, g in gh.items():
            top[reference_leaf(n)] = max(top.get(reference_leaf(n), 0.0), g.abs().max().item())
        worst = 0.0
        for n, g in gh.items():
            diff = (gc[n].cpu() - g).abs().max().item()
            tol = GRAD_ATOL + GRAD_RTOL * top[reference_leaf(n)]
            check(diff <= tol, f"{arch}: gradient {n} card - CPU {diff:.3g} above {tol:.3g}")
            worst = max(worst, diff / tol)
        again = TT.value_and_grad(card, on, model, tcfg)[2]
        differ = [n for n, g in gc.items() if not torch.equal(again[n], g)]
        check(not differ, f"{arch}: gradients differ on a rerun on the card: {differ[:6]}")
        T.set_remat_policy("off")
        try:
            plain = TT.value_and_grad(card, on, model, tcfg)[2]
        finally:
            T.set_remat_policy("batch_dots")
        off_equal = all(torch.equal(plain[n], g) for n, g in gc.items())
        state = TT.TrainState(card, opt.init(dict(card.named_parameters())), None)
        state, m = TT.train_step(state, on, model, tcfg)
        check(float(m["loss"]) == float(lc) and bool(torch.isfinite(m["grad_norm"])),
              f"{arch}: the step's loss {float(m['loss'])} != {float(lc)}")
        errs[cfg.name] = (f"loss {float(lc):.4f}, grads at {worst:.3f} of the tolerance, "
                          f"remat off {'bitwise' if off_equal else 'within tolerance'}")
        del card, state, gc, again, plain
    torch.cuda.empty_cache()
    print(f"[23a train families] {len(errs)} families at their reduced configs, one step "
          f"on {TRAIN_B}x{TRAIN_S} tokens, card = CPU (loss within 1e-5, every gradient "
          f"within {GRAD_ATOL} + {GRAD_RTOL}*max|g| of its leaf), gradients bitwise "
          f"equal on a rerun on the card: " + "; ".join(f"{k}: {v}" for k, v in errs.items()))


def forward_product_flops(cfg, bsz: int, seq: int) -> float:
    """The FLOPs of one forward's products (2 a multiply-add): projections,
    MLPs, attention's scores and weighted sums, the SSD's chunk products,
    and the logits. A train step runs 3x these (the backward twice the
    forward); a recompute under remat is not counted (the least work)."""
    t, d = bsz * seq, cfg.d_model
    flops = 2.0 * t * d * cfg.vocab_size  # logits
    attn = (2.0 * t * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_ if cfg.n_heads
            else 0.0)
    if cfg.n_heads:
        attn += 2.0 * t * cfg.n_heads * cfg.head_dim_ * d  # wo
        attn += 4.0 * bsz * cfg.n_heads * seq * seq * cfg.head_dim_  # scores, weighted sum
    if cfg.family in ("dense", "vlm"):
        return flops + cfg.n_layers * (attn + 2.0 * t * d * cfg.d_ff * 3)
    if cfg.family == "ssm":
        q = cfg.ssm_chunk
        s_pad = -(-seq // q) * q
        h, n, p, di = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.d_inner
        tp = bsz * s_pad
        ssd = 2.0 * tp * q * n + 2.0 * tp * q * h * p + 2 * 2.0 * tp * h * n * p
        proj = 2.0 * t * d * (2 * di + 2 * n + h) + 2.0 * t * di * d
        return flops + cfg.n_layers * (ssd + proj)
    raise ValueError(f"no FLOP count for family {cfg.family}")


def train_phase(torch, arch: str, f32_rate: float, mem_bw: float, smi: str,
                tag: str) -> dict:
    """Phases 23b-c: ``python -m repro_torch.launch.train --arch <arch>
    --batch 8 --seq 128 --steps 20 --device cuda`` (the published config in
    float32, remat on under ``batch_dots``, TF32 off) in this process: the
    median of the warm steps' CUDA-event times against the step's bound
    (3x the forward's product FLOPs at the f32 peak, or params, grads and
    both moments read and written once over the memory rate), tokens/s, the
    peak, and a falling loss; then 3 steps at TRAIN_PEAK_SEQ with remat
    ``off`` and ``batch_dots``, each one's peak and step time."""
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    argv = ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--device", "cuda"]
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(argv)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    cfg = out.model.cfg
    n_params = sum(p.numel() for p in out.state.params.parameters())
    check(len(out.losses) >= 2 and all(np.isfinite(out.losses)), f"{arch}: losses {out.losses}")
    check(out.losses[-1] < out.losses[0], f"{arch}: the loss did not fall: {out.losses}")
    logged = [round(x, 4) for x in out.losses]
    warm = out.step_ms[2:]
    step_ms = statistics.median(warm)
    flops = 3 * forward_product_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bytes_ = 4 * n_params * 8  # params, grads, mu, nu: each read and written once
    bound_ms = max(flops / f32_rate, bytes_ / mem_bw) * 1e3
    by = "operations" if flops / f32_rate >= bytes_ / mem_bw else "bytes"
    del out
    torch.cuda.empty_cache()

    seq = TRAIN_PEAK_SEQ[arch]
    peaks, losses = {}, {}
    for policy in ("off", "batch_dots"):
        T.set_remat_policy(policy)
        torch.cuda.reset_peak_memory_stats()
        try:
            run = train.run(["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(seq),
                             "--steps", "3", "--log-every", "1", "--device", "cuda"])
        finally:
            T.set_remat_policy("batch_dots")
        peaks[policy] = (torch.cuda.max_memory_allocated() / 1e9 - held_gb,
                         statistics.median(run.step_ms[1:]))
        losses[policy] = run.losses
        del run
        torch.cuda.empty_cache()
    check(np.allclose(losses["off"], losses["batch_dots"], rtol=1e-5, atol=0),
          f"{arch}: remat changed the losses: {losses}")
    same = "bitwise" if losses["off"] == losses["batch_dots"] else "within 1e-5"
    print(f"[{tag} lm train] {cfg.name} at published widths and depth ({cfg.n_layers} layers, "
          f"d={cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M params, f32, TF32 "
          f"off) through `python -m repro_torch.launch.train {' '.join(argv[:-2])}` on {smi}: "
          f"{TRAIN_STEPS} steps in {wall:.2f} s (init included), losses logged {logged} | step {step_ms:.3f} ms (median of "
          f"{len(warm)} warm steps; min {min(warm):.3f}, max {max(warm):.3f}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tokens/s | bound {bound_ms:.3f} ms "
          f"(by {by}: {flops / 1e12:.3f} TFLOP at {f32_rate / 1e12:.0f} TFLOP/s f32, "
          f"{bytes_ / 1e9:.2f} GB at {mem_bw / 1e12:.2f} TB/s): {bound_ms / step_ms:.3f} of it | "
          f"peak {peak_gb:.2f} GB above the {held_gb:.2f} GB earlier phases hold | at S={seq}, "
          f"3 steps: remat off peak {peaks['off'][0]:.2f} GB, step {peaks['off'][1]:.3f} ms; "
          f"batch_dots peak {peaks['batch_dots'][0]:.2f} GB, step {peaks['batch_dots'][1]:.3f} "
          f"ms; losses {same}")
    return {"step_ms": step_ms, "bound_ms": bound_ms}


def crash_resume_phase(torch, root: str, smi: str) -> None:
    """Phase 23d: qwen1.5-0.5b at published width, 6 steps straight against
    3 steps, ``--fail-at-step 3`` and a resume, with the checkpoint under
    build/train_ckpt (deleted afterwards): the final params bitwise equal,
    the resumed steps' losses equal; the checkpoint's size and the time of
    a synchronous save of the final state."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.training.checkpoint import CheckpointManager

    ckpt_dir = os.path.join(root, "build", "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    base = ["--arch", LM_TRAIN[0], "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", "6", "--log-every", "1", "--device", "cuda"]
    try:
        straight = train.run(base)
        want = {n: p.detach().cpu() for n, p in straight.state.params.named_parameters()}
        want_losses = straight.losses
        del straight
        torch.cuda.empty_cache()
        try:
            train.run(base + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2", "--fail-at-step", "3"])
            fail("--fail-at-step 3 did not raise")
        except RuntimeError as exc:
            check("injected failure at step 3" in str(exc), f"unexpected failure: {exc}")
        torch.cuda.empty_cache()
        resumed = train.run(base + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "100"])
        check(resumed.start_step == 3, f"resumed from step {resumed.start_step}, not 3")
        check(resumed.losses == want_losses[3:],
              f"resumed losses {resumed.losses} != straight {want_losses[3:]}")
        differ = [n for n, p in resumed.state.params.named_parameters()
                  if not torch.equal(p.detach().cpu(), want[n])]
        check(not differ, f"resumed params differ from the straight run's: {differ[:6]}")
        size_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                      os.walk(os.path.join(ckpt_dir, "step-6")) for f in fs) / 1e9
        sync = CheckpointManager(os.path.join(ckpt_dir, "sync"), async_write=False)
        t0 = time.perf_counter()
        sync.save(6, resumed.state)
        save_s = time.perf_counter() - t0
        del resumed
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[23d train crash and resume] {LM_TRAIN[0]} at published width, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} on {smi}: 6 steps straight = 3 steps, `--fail-at-step 3` and a "
          f"resume from step 3: params bitwise equal, resumed losses equal "
          f"{[round(x, 4) for x in want_losses[3:]]} | checkpoint {size_gb:.2f} GB "
          f"(params and both moments, npz), a synchronous save {save_s:.2f} s (copy to the "
          f"host, write, fsync, rename)")


def dryrun_phase(root: str) -> None:
    """Phase 24a: the dry-run's cells in a subprocess (the fake world is
    this process's default group there, and CUDA stays untouched), each
    record read back and checked."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.roofline import analysis as RA

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS), DRYRUN_TAG],
        cwd=root, env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
        capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"dry-run subprocess rc {out.returncode}: "
          f"{out.stdout[-1500:]} {out.stderr[-1500:]}")
    frac = json.loads(out.stdout.strip().splitlines()[-1])["per_rank_fraction"]
    check(frac == 1 / 16, f"a Shard(1) product over model=16 counted at {frac} of its FLOPs")
    files = [(f"{specs.get_cell(a, sh).arch}__{sh}", specs.get_cell(a, sh))
             for a, sh in DRYRUN_CELLS] + [("paraqaoa__qaoa_alternating", None)]
    for stem, cell in files:
        with open(os.path.join(dryrun.RESULTS_DIR, f"{stem}__singlepod__{DRYRUN_TAG}.json")) as f:
            rec = json.load(f)
        check(rec["status"] == "ok" and rec["cuda_initialized"] is False,
              f"dry-run {stem}: {rec.get('status')} {rec.get('error', '')[:300]}, "
              f"CUDA initialised {rec.get('cuda_initialized')}")
        ratio = rec["flops_per_device"] * rec["chips"] / rec["model_flops"]
        if cell is not None and cell.kind in ("train", "prefill"):
            check(ratio >= 1.0, f"dry-run {stem}: FLOPs a device x chips {ratio:.3f} "
                  "of the model's")
        coll = rec["collectives"]
        print(f"[24a dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
              f"({rec['route']}): FLOPs/device {rec['flops_per_device']:.4e} "
              f"(x {rec['chips']} = {ratio:.3f} x model {rec['model_flops']:.4e}) | "
              f"bytes/device {rec['bytes_per_device']:.4e} | collectives "
              f"{coll['counts']}, wire {rec['collective_wire_bytes']:.4e} B | "
              f"compute {rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, "
              f"collective {rec['collective_s']:.6f} s on the {RA.DATA_SHEET} data "
              f"sheet | bottleneck {rec['bottleneck']} | traced in "
              f"{rec['compile_s']:.1f} s, CUDA initialised {rec['cuda_initialized']}")
    print(f"[24a dryrun] {len(files)} records ok; a column-parallel product over "
          f"model=16 counted at {frac} of its dense FLOPs; subprocess "
          f"{time.perf_counter() - t0:.1f} s")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def placement_phase(torch, dev, smi: str) -> None:
    """Phase 24b: the sharding rules on the card. Each arch at its
    published width in f32 is placed by ``params_shardings`` on a one-rank
    NCCL mesh (data=1, model=1); its 4 x 128 forward is held bitwise
    against the one-device forward, and ``reshard_state`` brings every
    parameter back to the card alone, bitwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models import layers as ML
    from repro_torch.models.model import build_model
    from repro_torch.training.fault_tolerance import reshard_state

    torch.cuda.set_device(torch.cuda.current_device())  # the mesh's device, named
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = device_mesh((1, 1), ("data", "model"), "cuda")
        for arch in PLACE_ARCHS:
            cfg, _ = resolve_config(arch, reduced=False)
            model = build_model(cfg)
            params = model.init(0, device=dev)
            tokens = lm_batch(torch, cfg, PLACE_BATCH, PLACE_SEQ, seed=24)["tokens"].to(dev)
            with torch.no_grad():
                want = model.forward(params, {"tokens": tokens})[0]
                one_ms = time_ms(torch, lambda: model.forward(params, {"tokens": tokens}), 3)
            kept = {n: p.detach().clone() for n, p in params.named_parameters()}
            shard = SH.params_shardings(params, cfg, mesh)
            reshard_state(params, shard)
            check(all(isinstance(p, DTensor) for p in params.parameters()),
                  f"{arch}: a parameter was not placed")
            batch = {"tokens": SH.place(tokens, SH.batch_specs(cfg, mesh, "prefill")["tokens"], mesh)}
            ML.configure_shard_hints(mesh.mesh_dim_names)
            try:
                with torch.no_grad(), implicit_replication():
                    got = model.forward(params, batch)[0].full_tensor()
                    mesh_ms = time_ms(torch, lambda: model.forward(params, batch), 3)
            finally:
                ML.configure_shard_hints(())
            check(torch.equal(got, want), f"{arch}: the placed forward differs from the "
                  f"one-device forward by {(got - want).abs().max().item():.3g}")
            reshard_state(params, dev)
            back = dict(params.named_parameters())
            check(all(not isinstance(p, DTensor) and p.device == want.device
                      and torch.equal(p, kept[n]) for n, p in back.items()),
                  f"{arch}: reshard_state back to the card changed a parameter")
            print(f"[24b placement] {arch} ({cfg.n_params() / 1e9:.3f} B params, f32) on "
                  f"a one-rank NCCL mesh (data=1, model=1): {len(shard)} leaves placed, "
                  f"{PLACE_BATCH} x {PLACE_SEQ} forward bitwise equal to the one-device "
                  f"forward; one-device {one_ms:.3f} ms, placed {mesh_ms:.3f} ms | "
                  f"reshard_state back to the card bitwise | {smi}")
            del params, kept, want, got, back
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _remesh_rank(rank: int, port: int, src: str, queue) -> None:
    """One rank of phase 24c: reduced qwen placed on (data=1, model=2), then
    re-meshed from those shards onto (data=2, model=1), each forward
    against the one-device forward."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import layers as ML
    from repro_torch.models.model import build_model
    from repro_torch.training.fault_tolerance import reshard_state

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    cfg = configs.get_reduced("qwen1_5_0_5b")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    tokens = (torch.arange(2 * 16, dtype=torch.int32, device="cuda").reshape(2, 16)
              % cfg.vocab_size)
    with torch.no_grad():
        want = model.forward(params, {"tokens": tokens})[0]
    errs = []
    ML.configure_shard_hints(("data", "model"))
    for shape in ((1, 2), (2, 1)):
        mesh = device_mesh(shape, ("data", "model"), "cuda")
        reshard_state(params, SH.params_shardings(params, cfg, mesh))
        batch = {"tokens": SH.place(tokens, ("data", None), mesh)}
        with torch.no_grad(), implicit_replication():
            got = model.forward(params, batch)[0].full_tensor()
        errs.append((got - want).abs().max().item())
    queue.put((rank, errs))
    dist.barrier()
    dist.destroy_process_group()


def remesh_phase(torch, root: str) -> None:
    """Phase 24c: the elastic re-mesh over NCCL, where there are two cards."""
    if torch.cuda.device_count() < 2:
        print(f"[24c remesh] not run: {torch.cuda.device_count()} CUDA device(s) visible, "
              "the (1, 2) -> (2, 1) re-mesh needs 2 (tests/test_torch_sharding.py runs "
              "(2, 4) -> (4, 2) -> one device over 8 gloo ranks on the CPU)")
        return
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_remesh_rank, args=(_free_port(), os.path.join(root, "src"), queue),
                   nprocs=2, join=False)
    got = sorted((queue.get() for _ in range(2)), key=lambda r: r[0])
    while not ctx.join():
        pass
    worst = max(max(errs) for _, errs in got)
    check(worst <= REMESH_ATOL, f"re-mesh forwards off by {worst} (tol {REMESH_ATOL})")
    print(f"[24c remesh] reduced qwen1.5-0.5b over 2 NCCL ranks: (1, 2) then (2, 1) "
          f"from the sharded state, forwards within {worst:.3g} of one device "
          f"(tol {REMESH_ATOL})")


def train_profile_phase(torch, s23) -> None:
    """Phase 23e, after every timed part of the smoke: one profiled
    qwen1.5-0.5b train step at published width (B = 8, S = 128): the
    kernels it launches, the card's busy time against the step's wall, so
    the idle share, the kernels with the most device time, and the share of
    the loss (CUDA events: its forward and backward on the step's logits,
    and the gold-logit gather alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import resolve_config
    from repro_torch.models import build_model
    from repro_torch.training import data
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as TT

    cfg = resolve_config(LM_TRAIN[0], reduced=False)[0]
    model = build_model(cfg)
    tcfg = TT.TrainConfig(adamw=opt.AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS))
    state = TT.init_state(model, 0, tcfg, "cuda")
    dcfg = data.DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    batches = [data.synthetic_batch(cfg, dcfg, i, "cuda") for i in range(3)]
    for batch in batches[:2]:  # warm
        state, _ = TT.train_step(state, batch, model, tcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = TT.train_step(state, batches[2], model, tcfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    kernels = sum(ev.count for ev in evs)
    busy = sum(ev.self_device_time_total for ev in evs) / 1e3
    idle = (f"kernels busy {busy:.3f} ms of the step's {wall:.3f} ms wall: idle "
            f"{1 - busy / wall:.1%}, {1 - busy / s23['step_ms']:.1%} of 23b's unprofiled "
            f"median step" if busy else
            "idle share not measured (the profiler saw no device events)")
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:5]
    del state
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), device="cuda",
                         generator=gen, requires_grad=True)
    labels = batches[2]["labels"]

    def loss_fwd_bwd():
        torch.autograd.grad(TT.cross_entropy(logits, labels, tcfg.z_loss), logits)

    def gather_fwd_bwd():
        gold = torch.gather(logits, -1, labels[..., None])
        torch.autograd.grad(gold.sum(), logits)

    ce_ms = time_ms(torch, loss_fwd_bwd, 5)
    gather_ms = time_ms(torch, gather_fwd_bwd, 5)
    del logits
    torch.cuda.empty_cache()
    print(f"[23e train profile] {cfg.name}, one train step at B={TRAIN_BATCH} S={TRAIN_SEQ}: "
          f"{kernels} kernels, {idle} ({s23['step_ms']:.3f} ms) | the loss (logsumexp, gold "
          f"gather, z-loss; forward and backward on the (B, S, V) logits) {ce_ms:.3f} ms, "
          f"{ce_ms / s23['step_ms']:.1%} of the step; the gather alone {gather_ms:.3f} ms "
          f"(its backward: a zero fill and one scattered value a row) | most device time: "
          + ", ".join(f"{ev.key[:40]} {ev.self_device_time_total / 1e3:.3f} ms x{ev.count}"
                      for ev in top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core import merge as merge_mod
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph, Problem
    from repro_torch.core.partition import partition_for_solver, split_linear
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, betagrad, fused_layer, mixer, ops, phase, ref
    from repro_torch.kernels import cutvals as cutvals_mod
    from repro_torch.roofline import analysis

    dev = resolve_device("cuda")  # also pins f32 products to full f32

    # ---- 1. card -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    peak_key, (f32_rate, mem_bw) = analysis.peaks_for(card)
    print(f"[1 card] {card} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | kernels built in {build_s:.2f} s | "
          f"bounds use the {peak_key} data sheet: {mem_bw / 1e12:.2f} TB/s, "
          f"{f32_rate / 1e12:.0f} TFLOP/s f32, "
          f"{analysis.TENSOR_BF16_PEAKS[peak_key] / 1e12:.0f} TFLOP/s bf16 tensor cores")

    # ---- 21. the solve service, run first: no profiler session before it ------
    cal_path = calibration_phase(torch, root, smi)
    s21 = service_phase(torch, dev, ops)
    dispatch_phase(torch, s21)
    mesh_service_phase(torch, s21)
    stream_phase(torch, s21)
    soak_phase(torch, cal_path, s21["throughput"])
    # ---- 22. the LM serve path, before the first profiler trace ---------------
    lm_families_phase(torch, dev)
    s22 = lm_serve_phase(torch, LM_SERVE[0], mem_bw, "22b")
    lm_serve_phase(torch, LM_SERVE[1], mem_bw, "22c")
    torch.cuda.empty_cache()
    # ---- 23. the train path, before the first profiler trace -----------------
    train_families_phase(torch, dev)
    s23 = train_phase(torch, LM_TRAIN[0], f32_rate, mem_bw, smi, "23b")
    train_phase(torch, LM_TRAIN[1], f32_rate, mem_bw, smi, "23c")
    crash_resume_phase(torch, root, smi)
    # ---- 24. the dry-run and the sharding rules, before the profiler ----------
    dryrun_phase(root)
    placement_phase(torch, dev, smi)
    remesh_phase(torch, root)

    service_profile_phase(torch, s21)
    del s21["svc"]
    torch.cuda.empty_cache()

    # ---- 2. kernels against their plain versions at the main path's shapes --
    rng = np.random.default_rng(0)
    graph = Graph.erdos_renyi(400, 0.1, seed=0)
    part = partition_for_solver(graph, N_MAIN)
    check(part.m == B_MAIN, f"partition gave M={part.m}, expected {B_MAIN}")
    edges, weights, _ = qaoa_mod.pad_subgraph_arrays(part.subgraphs, N_MAIN,
                                                     device=dev)
    lin = torch.as_tensor(rng.standard_normal((B_MAIN, N_MAIN), dtype=np.float32),
                          device=dev)
    dim = 2**N_MAIN
    amps = B_MAIN * dim
    results = {}

    def record(name, err, ms, plain_ms, bytes_, flops, library_ms=None, unit="f32"):
        results[name] = {
            "name": name, "route": "cuda",
            "source": KERNEL_META[name][0], "replaces": KERNEL_META[name][1],
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": analysis.kernel_bound_s(flops, bytes_, peak_key, unit) * 1e3,
            "bound_by": analysis.bound_by(flops, bytes_, peak_key, unit),
            "library_ms": library_ms,
        }

    # cutvals (table pass + fill): bitwise on integer weights, without and
    # with integer linear rows (every sum an exact integer); with real linear
    # rows within CUTVALS_AT_RTOL of each row's Σ|w| + Σ|h| (table order, not
    # edge order) and bitwise equal to the mirror run on the same tensors
    lin_int = torch.as_tensor(np.random.default_rng(5).integers(-3, 4, (B_MAIN, N_MAIN))
                              .astype(np.float32), device=dev)
    line = []
    err_max = 0.0
    for label, linear in (("no linear", None), ("integer linear rows", lin_int),
                          ("real linear rows", lin)):
        got = cutvals_mod.cutvals(N_MAIN, edges, weights, linear)
        want = ref.cutvals(N_MAIN, edges, weights, linear)
        torch.cuda.synchronize()
        err = (got - want).abs().amax(1)
        if linear is not lin:
            check(torch.equal(got, want), f"cutvals ({label}) differs from its plain "
                  f"version by {float(err.max())}")
            line.append(f"{label}: bitwise equal")
        else:
            tol = cutvals_mod.CUTVALS_AT_RTOL * ref.append_linear_rows(
                edges, weights, linear)[1].abs().sum(1)
            check(bool((err <= tol).all()), f"cutvals ({label}): max_abs_err "
                  f"{float(err.max())} above the tolerance {float(tol.min())}")
            del want
            mirror = ref.cutvals_split(N_MAIN, edges, weights, linear)
            check(torch.equal(got, mirror), f"cutvals ({label}) differs from "
                  "ref.cutvals_split")
            err_max = float(err.max())
            line.append(f"{label}: within {err_max:.3g} (tol {float(tol.min()):.3g}) "
                        "and bitwise equal to ref.cutvals_split")
            del mirror
        del got
    torch.cuda.empty_cache()
    ms = time_ms(torch, lambda: cutvals_mod.cutvals(N_MAIN, edges, weights), 10)
    table_ms = time_ms(torch, lambda: cutvals_mod.split_tables(edges, weights, N_MAIN), 10)
    plain = time_ms(torch, lambda: ref.cutvals(N_MAIN, edges, weights), 2)
    real_edges = int((weights != 0).sum())
    # bytes: the (B, 2^n) output and the edge rows once; operations: the
    # fill's adds, T_lo + T_hi and one a set bit of lo (l / 2 on average)
    record("cutvals", err_max, ms, plain, bytes_=4 * amps + 12 * B_MAIN * edges.shape[1],
           flops=amps * (1 + min(N_MAIN, cutvals_mod.LO_BITS) / 2))
    r = results["cutvals"]
    print(f"[2 kernel cutvals] B={B_MAIN} n={N_MAIN} E_pad={edges.shape[1]} "
          f"({real_edges} real edges), l={cutvals_mod.LO_BITS} | " + " | ".join(line)
          + f" | kernel {ms:.3f} ms (table pass alone {table_ms:.3f} ms), plain "
          f"{plain:.1f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    cutv = ref.cutvals(N_MAIN, edges, weights)

    gamma = torch.as_tensor(rng.uniform(-1, 1, B_MAIN).astype(np.float32), device=dev)
    beta = torch.as_tensor(rng.uniform(-1, 1, B_MAIN).astype(np.float32), device=dev)
    re = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    im = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    norm = torch.sqrt(torch.sum(re * re + im * im, dim=1, keepdim=True))
    re.div_(norm)  # unit-norm rows, as a statevector has
    im.div_(norm)
    del norm
    state_rtol = 1e-5  # of max|ref|: 2^k-term dense product vs k butterflies in f32

    def planes_err(got, want):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        return err, state_rtol * scale

    dk = 2**GROUP
    v3 = (B_MAIN, dim // dk, dk)
    errs = []
    for reverse in (False, True):
        args = (re.view(v3), im.view(v3), cutv.view(v3), gamma, beta, GROUP)
        err, tol = planes_err(
            fused_layer.fused_phase_mixer_group(*args, reverse=reverse),
            fused_layer.fused_phase_mixer_group_plain(*args, reverse))
        torch.cuda.synchronize()
        check(err <= tol, f"fused reverse={reverse} max_abs_err {err} > {tol}")
        errs.append(f"reverse={reverse}: {err:.3g} (tol {tol:.3g})")
        if not reverse:
            ms = time_ms(torch, lambda: fused_layer.fused_phase_mixer_group(*args), 10)
            plain = time_ms(torch, lambda: fused_layer.fused_phase_mixer_group_plain(*args), 3)
            record("fused_phase_mixer_group", err, ms, plain, bytes_=20 * amps,
                   flops=amps * (6 + 6 * GROUP))
        results["fused_phase_mixer_group"]["max_abs_err"] = max(
            results["fused_phase_mixer_group"]["max_abs_err"], err)
    r = results["fused_phase_mixer_group"]
    print(f"[2 kernel fused_phase_mixer_group] view {v3} k={GROUP} | max_abs_err "
          + ", ".join(errs) + f" | kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")

    for lo_bit, k in ((7, 7), (14, 7), (21, 3)):
        shape = (B_MAIN, 2 ** (N_MAIN - lo_bit - k), 2**k, 2**lo_bit)
        r3, i3 = re.view(shape), im.view(shape)
        err, tol = planes_err(mixer.mixer_group_strided(r3, i3, beta, k),
                              ref.mixer_group(r3, i3, beta, k))
        torch.cuda.synchronize()
        check(err <= tol, f"strided mixer lo_bit={lo_bit} max_abs_err {err} > {tol}")
        ms = time_ms(torch, lambda: mixer.mixer_group_strided(r3, i3, beta, k), 10)
        plain = time_ms(torch, lambda: ref.mixer_group(r3, i3, beta, k), 3)
        C, D = ref.rx_kron_parts(beta, k)
        u = torch.complex(C, D)
        xc = torch.complex(r3, i3)
        lib = time_ms(torch, lambda: torch.einsum("bac,bxcy->bxay", u, xc), 3)
        del u, xc
        bound = 16 * amps / mem_bw * 1e3
        print(f"[2 kernel mixer_group_strided] lo_bit={lo_bit} k={k} view {shape} | "
              f"max_abs_err {err:.3g} (tol {tol:.3g}) | kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, complex einsum {lib:.3f} ms, bound {bound:.3f} ms (bytes)")
        if "mixer_group_strided" not in results:  # the lo_bit = 7 case
            record("mixer_group_strided", err, ms, plain, bytes_=16 * amps,
                   flops=amps * 6 * k, library_ms=lib)
        else:
            r = results["mixer_group_strided"]
            r["max_abs_err"] = max(r["max_abs_err"], err)

    # the trailing-axis mixer: k = 7 on the contiguous axis of the planes
    v3 = (B_MAIN, dim // dk, dk)
    r3, i3 = re.view(v3), im.view(v3)
    err, tol = planes_err(mixer.mixer_group_trailing(r3, i3, beta, GROUP),
                          mixer.mixer_group_trailing_plain(r3, i3, beta, GROUP))
    torch.cuda.synchronize()
    check(err <= tol, f"trailing mixer max_abs_err {err} > {tol}")
    ms = time_ms(torch, lambda: mixer.mixer_group_trailing(r3, i3, beta, GROUP), 10)
    plain = time_ms(torch, lambda: mixer.mixer_group_trailing_plain(r3, i3, beta,
                                                                    GROUP), 3)
    C, D = ref.rx_kron_parts(beta, GROUP)
    u = torch.complex(C, D)
    xc = torch.complex(r3, i3)
    lib = time_ms(torch, lambda: torch.einsum("bac,bxc->bxa", u, xc), 3)
    del u, xc
    record("mixer_group_trailing", err, ms, plain, bytes_=16 * amps,
           flops=amps * 6 * GROUP, library_ms=lib)
    r = results["mixer_group_trailing"]
    print(f"[2 kernel mixer_group_trailing] view {v3} k={GROUP} | max_abs_err {err:.3g} "
          f"(tol {tol:.3g}) | kernel {ms:.3f} ms, plain {plain:.3f} ms, complex einsum "
          f"{lib:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")

    got = phase.expectation(re, im, cutv)
    want = ref.expectation(re, im, cutv)
    again = phase.expectation(re, im, cutv)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= 1e-5, f"expectation max rel err {rel} > 1e-5")
    check(torch.equal(got, again), "expectation is not bitwise repeatable")
    ms = time_ms(torch, lambda: phase.expectation(re, im, cutv), 10)
    plain = time_ms(torch, lambda: ref.expectation(re, im, cutv), 3)
    record("expectation", float((got - want).abs().max()), ms, plain,
           bytes_=12 * amps, flops=4 * amps)
    r = results["expectation"]
    print(f"[2 kernel expectation] (B, 2^n)=({B_MAIN}, {dim}) | max rel err {rel:.3g} "
          f"(tol 1e-5), bitwise repeatable | kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    del got, want, again

    # ∂γ of the phase rule: within 1e-5 of the plain version relative to
    # Σ|c·t| a row, bitwise repeatable, and each row's bits the same in a
    # batch of 1 and of 16 as in the batch of 18 (a torch reduction takes
    # its block shape and split from the row count)
    g_re = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    g_im = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    got = phase.phase_grad(re, im, g_re, g_im, cutv)
    want = ref.phase_grad(re, im, g_re, g_im, cutv)
    scale = torch.sum((cutv * (im * g_re - re * g_im)).abs(), dim=-1)
    rel = float(((got - want).abs() / scale).max())
    check(rel <= 1e-5, f"phase_grad max err {rel} of sum|c t| > 1e-5")
    check(torch.equal(got, phase.phase_grad(re, im, g_re, g_im, cutv)),
          "phase_grad is not bitwise repeatable")
    for rows in (slice(0, 1), slice(2, 18)):
        part = phase.phase_grad(re[rows], im[rows], g_re[rows], g_im[rows], cutv[rows])
        check(torch.equal(part, got[rows]), f"phase_grad rows {rows} differ alone")
    plain_rows = [ref.phase_grad(re[r], im[r], g_re[r], g_im[r], cutv[r])
                  for r in (slice(0, 1), slice(2, 18))]
    plain_moves = not (torch.equal(plain_rows[0], want[0:1])
                       and torch.equal(plain_rows[1], want[2:18]))
    ms = time_ms(torch, lambda: phase.phase_grad(re, im, g_re, g_im, cutv), 10)
    plain = time_ms(torch, lambda: ref.phase_grad(re, im, g_re, g_im, cutv), 3)
    record("phase_grad", float((got - want).abs().max()), ms, plain,
           bytes_=20 * amps, flops=4 * amps)
    r = results["phase_grad"]
    print(f"[2 kernel phase_grad] (B, 2^n)=({B_MAIN}, {dim}) | max err {rel:.3g} of "
          f"sum|c t| (tol 1e-5), bitwise repeatable, rows [0, 1) and [2, 18) alone "
          f"bitwise equal to the batch's (the plain torch.sum's bits "
          f"{'move' if plain_moves else 'do not move'} with the batch here) | kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    del got, want, scale, g_re, g_im, plain_rows

    err, tol = planes_err(phase.apply_phase(re, im, cutv, gamma),
                          ref.apply_phase(re, im, cutv, gamma))
    torch.cuda.synchronize()
    check(err <= tol, f"apply_phase max_abs_err {err} > {tol}")
    ms = time_ms(torch, lambda: phase.apply_phase(re, im, cutv, gamma), 10)
    plain = time_ms(torch, lambda: ref.apply_phase(re, im, cutv, gamma), 3)
    record("apply_phase", err, ms, plain, bytes_=20 * amps, flops=7 * amps)
    r = results["apply_phase"]
    print(f"[2 kernel apply_phase] (B, 2^n)=({B_MAIN}, {dim}), per-row gamma | "
          f"max_abs_err {err:.3g} (tol {tol:.3g}) | kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    # ∂β of the layer backward (all n qubits, as the solve calls it) and of
    # mixer groups, on seeded cotangents: within BETA_GRAD_RTOL · S of the
    # plain version a row (S = Σ_x Σ_q |products|), bitwise repeatable, and
    # each row's bits the same alone and in part of the batch as in all 18
    d_re = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    d_im = torch.as_tensor(rng.standard_normal((B_MAIN, dim), dtype=np.float32), device=dev)
    parts = []
    for lo_bit, nbits in ((0, N_MAIN), (7, 7), (14, 7), (21, 3)):
        bargs = (d_re, d_im, re, im, lo_bit, nbits)
        got = betagrad.beta_grad(*bargs)
        again = betagrad.beta_grad(*bargs)
        want = ref.beta_grad(*bargs)
        tol = betagrad.tolerance(*bargs)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= tol).all()), f"beta_grad qubits [{lo_bit}, {lo_bit + nbits}): "
              f"errors {err.tolist()} above the tolerances {tol.tolist()}")
        check(torch.equal(got, again), f"beta_grad qubits [{lo_bit}, {lo_bit + nbits}) "
              "is not bitwise repeatable")
        for rows in (slice(0, 1), slice(2, 18)):
            alone = betagrad.beta_grad(d_re[rows], d_im[rows], re[rows], im[rows], lo_bit,
                                       nbits)
            check(torch.equal(alone, got[rows]), f"beta_grad qubits [{lo_bit}, "
                  f"{lo_bit + nbits}): rows {rows} differ alone and in the batch")
        parts.append(f"qubits [{lo_bit}, {lo_bit + nbits}) in reads "
                     f"{[[tuple(p) for p in launch] for launch in ref.beta_grad_launches(lo_bit, nbits)]}"
                     f" (g0, k, lanes): max_abs_err "
                     f"{float(err.max()):.3g} (tol {float(tol.min()):.3g}, |dbeta| up to "
                     f"{float(want.abs().max()):.3g})")
        if lo_bit == 0:
            ms = time_ms(torch, lambda: betagrad.beta_grad(*bargs), 10)
            plain = time_ms(torch, lambda: ref.beta_grad(*bargs), 3)
            # bytes: the four planes read once; operations: 2 products, a
            # difference and an add a (state, qubit) pair
            record("beta_grad", float(err.max()), ms, plain,
                   bytes_=16 * amps + 4 * B_MAIN, flops=4 * amps * nbits)
        else:
            r = results["beta_grad"]
            r["max_abs_err"] = max(r["max_abs_err"], float(err.max()))
        del got, again, want, tol, alone
    r = results["beta_grad"]
    # each read of the planes alone, and the fused read's two groups apart
    # (each then reads the planes from HBM itself)
    reads = []
    for launch in ref.beta_grad_launches(0, N_MAIN):
        lo_bit, nbits = launch[0].g0, sum(p.k for p in launch)
        t = time_ms(torch, lambda: betagrad.beta_grad(d_re, d_im, re, im, lo_bit, nbits), 10)
        apart = [time_ms(torch, lambda: betagrad.beta_grad(d_re, d_im, re, im, p.g0, p.k), 10)
                 for p in launch] if len(launch) > 1 else []
        reads.append(f"qubits [{lo_bit}, {lo_bit + nbits}) {t:.3f} ms"
                     + (f" (its groups apart: {' + '.join(f'{a:.3f}' for a in apart)} ms)"
                        if apart else ""))
    n_pass = len(ref.beta_grad_launches(0, N_MAIN))
    check(n_pass <= 2, f"beta_grad reads the planes {n_pass} times over qubits [0, {N_MAIN})")
    # the same planes as states of other widths (the same bytes, so the same
    # bound a read): at n = 22 and 23 every read runs an instance of its own
    # (its groups fill their tiles); qubits [0, 10) at n = 24 are one read
    # of slabs of four, which only the generic instance takes
    widths = []
    for nw, lo_bit, nbits in ((22, 0, 22), (23, 0, 23), (N_MAIN, 0, 10)):
        v = [t.view(-1, 2**nw) for t in (d_re, d_im, re, im)]
        got = betagrad.beta_grad(*v, lo_bit, nbits)
        want = ref.beta_grad(*v, lo_bit, nbits)
        tol = betagrad.tolerance(*v, lo_bit, nbits)
        err = (got - want).abs()
        check(bool((err <= tol).all()), f"beta_grad at n = {nw} over qubits [{lo_bit}, "
              f"{lo_bit + nbits}): errors above the tolerances")
        check(torch.equal(got, betagrad.beta_grad(*v, lo_bit, nbits)),
              f"beta_grad at n = {nw} over qubits [{lo_bit}, {lo_bit + nbits}) is not "
              "bitwise repeatable")
        t = time_ms(torch, lambda: betagrad.beta_grad(*v, lo_bit, nbits), 10)
        reads_w = ref.beta_grad_launches(lo_bit, nbits)
        widths.append(f"n = {nw} ({v[0].shape[0]} rows) qubits [{lo_bit}, {lo_bit + nbits}) "
                      f"in reads {[[tuple(p) for p in launch] for launch in reads_w]}: "
                      f"{t:.3f} ms, {len(reads_w) * r['bound_ms'] / t:.2f} of the "
                      f"{len(reads_w)}-read floor, max_abs_err {float(err.max()):.3g} (tol "
                      f"{float(tol.min()):.3g})")
        del v, got, want, tol, err
    ptxas = [ln.strip() for ln in _build.ptxas_log("betagrad").splitlines()
             if "spill" in ln or "registers" in ln]
    spilled = [ln for ln in ptxas if spill_bytes(ln)]
    check(not spilled, f"betagrad.cu spills: {spilled}")
    regs = [int(m) for ln in ptxas for m in re_mod.findall(r"Used (\d+) registers", ln)]
    frames = {int(m) for ln in ptxas for m in re_mod.findall(r"(\d+) bytes stack frame", ln)}
    print(f"[2 kernel beta_grad] (B, 2^n)=({B_MAIN}, {dim}) | " + " | ".join(parts)
          + f" | all n qubits in {n_pass} reads of the planes: kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, one-read bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
          f"{n_pass}-read floor {n_pass * r['bound_ms']:.3f} ms ({r['bound_ms'] / r['ms']:.2f} "
          f"of the bound, {n_pass * r['bound_ms'] / r['ms']:.2f} of the floor), bitwise "
          f"repeatable, rows [0, 1) and [2, 18) alone bitwise equal to the batch's | reads: "
          + "; ".join(reads) + " | other widths: " + "; ".join(widths) + f" | ptxas (no "
          f"spill): {len(regs)} functions, {min(regs)}-{max(regs)} registers, stack frames "
          f"{sorted(frames)} bytes")
    del d_re, d_im, bargs
    del re, im, cutv, r3, i3, args  # views keep the planes alive too
    torch.cuda.empty_cache()
    kernel_cutvals_at(torch, graph, dev, record, results)
    kernel_cut_batch_dense(torch, dev, peak_key, record, results)

    # ---- 3. autograd rules (kernel path) against plain-PyTorch autograd -----
    bg, ng = 4, 16
    g_rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    x_re = g_rng.standard_normal((bg, 2**ng))
    x_im = g_rng.standard_normal((bg, 2**ng))
    norm = np.sqrt((x_re**2 + x_im**2).sum(1, keepdims=True))
    base = {"re": t(x_re / norm), "im": t(x_im / norm),
            "cutv": t(g_rng.uniform(0, ng, (bg, 2**ng))),
            "gamma": t(g_rng.uniform(-1, 1, bg)), "beta": t(g_rng.uniform(-1, 1, bg))}
    w_re, w_im = t(g_rng.standard_normal((bg, 2**ng))), t(g_rng.standard_normal((bg, 2**ng)))

    def grads(fn, names):
        leaves = {k: v.clone().requires_grad_(k in names) for k, v in base.items()}
        out = fn(leaves)
        loss = out.sum() if out.dim() == 1 else (w_re * out[0] + w_im * out[1]).sum()
        return torch.autograd.grad(loss, [leaves[k] for k in names])

    def stack(p):
        return torch.stack(p) if isinstance(p, tuple) else p

    cases = {
        "apply_layer": (
            lambda v: stack(ops.apply_layer(v["re"], v["im"], v["cutv"], v["gamma"],
                                            v["beta"], ng, GROUP)),
            lambda v: stack(ref.apply_mixer(*ref.apply_phase(v["re"], v["im"], v["cutv"],
                                                             v["gamma"]), ng, v["beta"], GROUP)),
            ["re", "im", "cutv", "gamma", "beta"]),
        "apply_mixer_bits": (
            lambda v: stack(ops.apply_mixer_bits(v["re"], v["im"], ng, 7, 7, v["beta"])),
            lambda v: stack(ref.apply_mixer_bits(v["re"], v["im"], ng, 7, 7, v["beta"])),
            ["re", "im", "beta"]),
        "expectation": (
            lambda v: ops.expectation(v["re"], v["im"], v["cutv"]),
            lambda v: ref.expectation(v["re"], v["im"], v["cutv"]),
            ["re", "im", "cutv"]),
        "apply_phase": (
            lambda v: stack(ops.apply_phase(v["re"], v["im"], v["cutv"], v["gamma"])),
            lambda v: stack(ref.apply_phase(v["re"], v["im"], v["cutv"], v["gamma"])),
            ["re", "im", "cutv", "gamma"]),
    }
    parts = []
    ops.reset_launch_counts()
    for name, (fk, fp, names) in cases.items():
        gk, gp = grads(fk, names), grads(fp, names)
        errs = {k: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for k, a, b in zip(names, gk, gp)}
        bad = {k: e for k, e in errs.items() if e > 1e-4}
        check(not bad, f"{name} gradient max rel err > 1e-4: {bad}")
        parts.append(f"{name}: " + ", ".join(f"d_{k} {e:.2g}" for k, e in errs.items()))
    bg_launches = ops.launch_counts()["beta_grad"]
    check(bg_launches == 2, f"{bg_launches} beta_grad launches in phase 3, expected 2 "
          "(the layer's backward and the mixer group's)")
    pg_launches = ops.launch_counts()["phase_grad"]
    check(pg_launches == 2, f"{pg_launches} phase_grad launches in phase 3, expected 2 "
          "(the layer's backward and the phase's)")
    print(f"[3 grads] B={bg} n={ng}, per-row angles, max rel err vs plain autograd "
          f"(tol 1e-4), dbeta through the beta_grad kernel ({bg_launches} launches), "
          f"dgamma through the phase_grad kernel ({pg_launches}) | " + " | ".join(parts))
    del base, w_re, w_im
    torch.cuda.empty_cache()

    # ---- 4. end to end at full width ----------------------------------------
    cfg = ParaQAOAConfig(n_qubits=N_MAIN)
    p, steps = cfg.p_layers, cfg.opt_steps
    predicted = predicted_solve_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = solve(graph, cfg, device="cuda")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_w = float(graph.total_weight())
    bw = merge_mod.exact_beam_width(cfg.top_k, out.partition.m, cap=cfg.beam_cap)
    print(f"[4 solve] G(400, 0.1, seed=0) maxcut N={N_MAIN} K={cfg.top_k} p={p} "
          f"steps={steps}: cut {out.cut_value:.1f} of total weight {total_w:.0f} "
          f"| M={out.partition.m} beam={bw} | "
          + " ".join(f"{k}={v:.3f}s" for k, v in out.timings.items())
          + f" | peak memory {peak_gb:.2f} GB | launches {counts} "
          f"predicted {predicted}")
    check(counts == predicted, f"launch counts {counts} != predicted {predicted}")
    check(out.cut_value > total_w / 2, f"cut {out.cut_value} <= half the weight")
    check(np.isfinite(out.cut_value), "cut is not finite")
    for name in results:
        results[name]["launches"] = counts[name]
    torch.cuda.empty_cache()
    profile_step(torch, ops, qaoa_mod, edges, weights, cfg, out.timings["solve_s"])

    # ---- 5 and 6. the same port on the card and on the CPU ------------------
    def candidates(instance, n_qubits, device, extra):
        """Stage-2 candidates with K + 1 marginals (for the tie rule)."""
        prob = instance if isinstance(instance, Problem) else Problem.maxcut(instance)
        part = partition_for_solver(prob.graph, n_qubits)
        e, w, masks = qaoa_mod.pad_subgraph_arrays(part.subgraphs, n_qubits, device=device)
        lin = None
        if prob.has_linear:
            lin = qaoa_mod.pad_linear_arrays(split_linear(part, prob.linear.numpy()),
                                             n_qubits, device=device)
        qcfg = ParaQAOAConfig(n_qubits=n_qubits, opt_steps=0).qaoa_config()
        cutv = ops.cutvals(n_qubits, e, w, lin)
        gam, bet = qaoa_mod.optimize_params(cutv, n_qubits, qcfg)
        with torch.no_grad():
            re, im = qaoa_mod.qaoa_statevector(cutv, n_qubits, gam, bet)
            idx, val = qaoa_mod.topk_marginal(re, im, n_qubits, masks, qcfg.top_k + extra)
        return idx.cpu().numpy(), val.cpu().numpy(), masks.cpu().numpy()

    def same_candidates(instance, n_qubits, complement):
        """Compare card and CPU candidates; a difference passes only where
        the K-th and (K+1)-th marginal tie within TIE_RTOL on both sides."""
        k = 2
        ig, vg, masks = candidates(instance, n_qubits, dev, 1)
        ic, vc, _ = candidates(instance, n_qubits, "cpu", 1)
        ties = []
        for row in range(ig.shape[0]):
            def canon(c):
                return {min(int(x), int(x) ^ int(masks[row])) if complement else int(x)
                        for x in c}
            if canon(ig[row, :k]) != canon(ic[row, :k]):
                tie = all(abs(v[row, k - 1] - v[row, k]) <= TIE_RTOL * v[row, k - 1]
                          for v in (vg, vc))
                check(tie, f"row {row}: card {ig[row, :k]} vs CPU {ic[row, :k]}, "
                      f"marginals card {vg[row]} CPU {vc[row]}: no tie")
                ties.append(row)
        return ties

    inst5 = Graph.erdos_renyi(60, 0.3, seed=1)
    ties = same_candidates(inst5, 10, complement=True)
    cfg0 = ParaQAOAConfig(n_qubits=10, opt_steps=0)
    cut_g = solve(inst5, cfg0, device="cuda").cut_value
    cut_c = solve(inst5, cfg0, device="cpu").cut_value
    check(bool(ties) or cut_g == cut_c, f"opt_steps=0 cut card {cut_g} != CPU {cut_c}")
    cfg10 = ParaQAOAConfig(n_qubits=10)
    full_g = solve(inst5, cfg10, device="cuda").cut_value
    full_c = solve(inst5, cfg10, device="cpu").cut_value
    scale = float(inst5.weights.abs().sum())
    check(abs(full_g - full_c) <= CPU_BAND * scale,
          f"default-steps cut card {full_g} vs CPU {full_c} outside "
          f"{CPU_BAND:.0%} of sum|w| = {scale}")
    print(f"[5 card vs cpu] G(60, 0.3, seed=1) N=10: opt_steps=0 candidates equal "
          f"modulo complement (tied rows {ties}), cut card {cut_g} CPU {cut_c} | "
          f"30 steps: card {full_g} CPU {full_c} (band {CPU_BAND:.0%} of sum|w| "
          f"= {CPU_BAND * scale:.1f})")

    inst6 = Problem.mis(Graph.erdos_renyi(60, 0.1, seed=2))
    ties = same_candidates(inst6, 10, complement=False)
    val_g = solve(inst6, cfg0, device="cuda").cut_value
    val_c = solve(inst6, cfg0, device="cpu").cut_value
    check(bool(ties) or val_g == val_c, f"MIS value card {val_g} != CPU {val_c}")
    print(f"[6 linear terms] MIS on G(60, 0.1, seed=2) N=10 opt_steps=0: candidates "
          f"equal (tied rows {ties}), value card {val_g} CPU {val_c}")

    # ---- 7-12. the sharded statevector (mesh model=4) ------------------------
    phase7 = sharded_solve_phases(torch, dev, graph)
    results["cutvals_at"]["launches"] = phase7["counts"]["cutvals_at"]
    results["mixer_group_trailing"]["launches"] = chunk_one_phase(torch, dev)
    nccl_phase(torch, root)

    # ---- 13. the block-shape sweep and the tuned solve -------------------------
    sweep_counts = tuning_phase(torch, dev, graph, peak_key, root)
    for name in ("apply_phase", "cut_batch_dense"):
        results[name]["launches"] = sweep_counts[name]

    # ---- 14-18. refinement, the headline solve, QAOA², the oracle, obs --------
    refine_phase(torch, graph, out.assignment)
    phase15 = headline_phase(torch, dev, peak_key)
    qaoa2_phase(torch, dev, graph)
    oracle_phase(torch, dev)
    obs_phase(torch, dev, graph, root)

    # ---- 19-20. the data axis on one card -------------------------------------
    data_axis_phase(torch, dev, graph, phase7)
    headline_data_phase(torch, phase15)

    for name in results:
        results[name]["service_launches"] = s21["counts"][name]
    lm_profile_phase(torch, s22)
    train_profile_phase(torch, s23)

    # ---- result lines ---------------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
