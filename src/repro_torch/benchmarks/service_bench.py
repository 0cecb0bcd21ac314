"""Closed-loop load generator for the Max-Cut solve service (DESIGN.md §6)
(port of ``benchmarks/service_bench.py``).

For each offered load R the same seed-stable request mix (varied sizes,
a fraction of relabeled repeats) runs twice:

  - **sequential** — one `core.solve` per request with the *same* planner
    knobs, back to back: the per-invocation baseline;
  - **batched** — through `SolveService`: cross-request packing into
    shape-bucketed batches (on the card one CUDA graph a bucket, all
    captured when the service is built, before its timed window),
    canonical-graph cache on.

Per-request cuts of non-cached batched requests are asserted bit-identical
to their sequential twins (the §6.1 parity contract). Writes
``build/bench/BENCH_service.json``: throughput and p50/p99 latency per
mode and load, speedup, cache-hit and batch-fill ratios. ``--smoke`` is
the tiny variant.

``--distributed`` (§Perf C8) instead exercises the §6.5 backends on a
``data`` mesh whose shards are row blocks of one batch on this card: the
same mix through the single-device `LocalBackend` and through
`MeshBackend` (`solve_pool` over the mesh), asserting bit-identical
per-request cuts across backends *and* against solo `core.solve`
(``cut_equal``), plus a sync-vs-async admission pair (``max_inflight`` 1
vs 4) at the highest load. Writes ``build/bench/BENCH_service_mesh.json``.
Recalibration is pinned off throughout: in the parity runs so both
backends plan identically, and in the async pair so both loops do
identical work (refits are timing-dependent, so leaving it on would
measure the planner, not the loop). Deadline enforcement (§6.6) is pinned
off in both parity modes for the same reason: a shed or downgraded
request has no bit-identical sequential twin to compare against.

``--sla-soak`` (§Perf C9) is the open-loop SLA attainment suite: for each
offered load (requests/s) the seed-stable `workload.arrival_trace`
(Poisson base rate + burst episodes + skewed tenants + a per-request
deadline/floor mix) replays in wall-clock time via
`workload.run_soak_wall` against a deadline-enforcing service with live
recalibration. Writes ``build/bench/BENCH_service_sla.json``: attainment,
shed/expired/downgrade rates, p50/p99 latency per offered load and per
tenant, with the ``attainment_ge_threshold`` claim at the calibrated
(lowest) load point.

    python -m repro_torch.benchmarks.service_bench [--distributed | --sla-soak] [--smoke] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks.common import bench_path, device_arg, emit, write_bench_json
from repro_torch.core import ParaQAOAConfig, solve
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import percentile
from repro_torch.service import SLA, Planner, ServiceConfig, SolveService
from repro_torch.service.workload import request_mix, tenant_mix


def _cfg_from_plan(plan) -> ParaQAOAConfig:
    return plan.to_config()


def _latency_row(name, mode, load, wall, latencies, **extra):
    # §8: percentiles come from the shared obs helper (exact nearest-rank),
    # the same math behind every Histogram.summary() in the service stats
    p50 = percentile(latencies, 0.5)
    p99 = percentile(latencies, 0.99)
    tput = load / wall if wall > 0 else 0.0
    return {
        "name": name,
        "runtime_s": wall,
        "derived": f"throughput={tput:.3f}rps;p50={p50:.3f}s;p99={p99:.3f}s",
        "mode": mode,
        "load": load,
        "throughput_rps": tput,
        "p50_s": p50,
        "p99_s": p99,
        **extra,
    }


def run(loads=(1, 2, 4, 8), n_range=(40, 100), p=0.15, seed=0,
        repeat_frac=0.25, deadline_s=20.0, batch_slots=16, max_qubits=10,
        save=True, device="cuda"):
    dev = resolve_device(device)
    planner = Planner(max_qubits=max_qubits, batch_slots=batch_slots)
    sla = SLA(deadline_s=deadline_s)

    # absorb one-time first-use noise outside the timed sections
    warm = Graph.erdos_renyi(n_range[0], p, seed=seed + 999)
    solve(warm, _cfg_from_plan(planner.plan(warm.n, warm.n_edges, sla)), device=dev)

    rows = []
    for load in loads:
        graphs = request_mix(load, n_range, p, repeat_frac, seed)
        plans = [planner.plan(g.n, g.n_edges, sla) for g in graphs]

        # ---- sequential per-request baseline -----------------------------
        seq_lat, seq_out = [], []
        t0 = time.perf_counter()
        for g, plan in zip(graphs, plans):
            ts = time.perf_counter()
            seq_out.append(solve(g, _cfg_from_plan(plan), device=dev))
            seq_lat.append(time.perf_counter() - ts)
        seq_wall = time.perf_counter() - t0
        rows.append(_latency_row(
            f"service/seq_load{load}", "sequential", load, seq_wall, seq_lat,
        ))

        # ---- batched service (fresh instance per load point; the planner
        # is shared with the sequential baseline, so recalibration is off
        # to keep the two modes' knob choices identical). Built before the
        # timed window: on the card it captures its buckets' graphs -------
        svc = SolveService(
            ServiceConfig(batch_slots=batch_slots, max_qubits=max_qubits,
                          recalibrate=False, enforce_deadlines=False,
                          device=str(dev)),
            planner=planner,
        )
        t0 = time.perf_counter()
        rids = [svc.submit(g, sla) for g in graphs]
        svc.drain()
        bat_wall = time.perf_counter() - t0
        bat_lat = [svc.results[rid].latency_s for rid in rids]
        rows.append(_latency_row(
            f"service/batched_load{load}", "batched", load, bat_wall, bat_lat,
            cache_hit_ratio=round(svc.cache.stats.hit_ratio, 4),
            fill_ratio=round(svc.stats.fill_ratio, 4),
            dispatches=svc.stats.dispatches,
        ))

        # ---- parity + speedup summary ------------------------------------
        cut_equal = True
        for rid, solo in zip(rids, seq_out):
            r = svc.results[rid]
            if r.cached:
                continue  # served isomorphic twin; cut checked by the cache
            cut_equal &= bool(
                r.cut_value == solo.cut_value
                and np.array_equal(r.assignment, solo.assignment)
            )
        speedup = seq_wall / bat_wall if bat_wall > 0 else float("inf")
        rows.append({
            "name": f"service/speedup_load{load}",
            "runtime_s": 0.0,
            "derived": f"speedup={speedup:.3f}x;cut_equal={cut_equal}",
            "load": load,
            "speedup": speedup,
            "cut_equal": cut_equal,
        })

    if save and rows:
        path = write_bench_json(bench_path("service"), "service", rows, dev)
        print(f"# wrote {path}")
    return rows


def _service_run(graphs, labels, sla, *, mesh=None, max_inflight=2,
                 recalibrate=False, batch_slots=16, max_qubits=10, device="cuda"):
    svc = SolveService(ServiceConfig(
        batch_slots=batch_slots, max_qubits=max_qubits, mesh=mesh,
        max_inflight=max_inflight, recalibrate=recalibrate,
        enforce_deadlines=False, device=str(device),
    ))
    t0 = time.perf_counter()
    rids = [svc.submit(g, sla, tenant=t) for g, t in zip(graphs, labels)]
    svc.drain()
    wall = time.perf_counter() - t0
    return svc, rids, wall


def run_distributed(loads=(2, 4, 8), mesh_devices=4, n_range=(40, 100),
                    p=0.15, seed=0, repeat_frac=0.25, deadline_s=20.0,
                    batch_slots=16, max_qubits=10, async_reps=2, save=True,
                    device="cuda"):
    """§6.5 backend + async-admission load curve → BENCH_service_mesh.json.

    The ``data`` mesh of ``mesh_devices`` shards lives in this process:
    each shard a row block of one batch on ``device``.
    """
    dev = resolve_device(device)
    mesh = f"data={mesh_devices}"
    sla = SLA(deadline_s=deadline_s)
    kw = dict(batch_slots=batch_slots, max_qubits=max_qubits, device=dev)

    # absorb one-time first-use noise for both backends
    warm_planner = Planner(max_qubits=max_qubits, batch_slots=batch_slots)
    warm = Graph.erdos_renyi(n_range[0], p, seed=seed + 999)
    _service_run([warm], ["t0"], sla, **kw)
    _service_run([warm], ["t0"], sla, mesh=mesh, **kw)
    solve(warm, _cfg_from_plan(warm_planner.plan(warm.n, warm.n_edges, sla)), device=dev)

    rows = []
    for load in loads:
        graphs = request_mix(load, n_range, p, repeat_frac, seed)
        labels = tenant_mix(load, 2, seed)

        svc_l, rids_l, wall_l = _service_run(graphs, labels, sla, **kw)
        svc_m, rids_m, wall_m = _service_run(graphs, labels, sla, mesh=mesh,
                                             **kw)
        rows.append(_latency_row(
            f"service_mesh/local_load{load}", "local", load, wall_l,
            [svc_l.results[r].latency_s for r in rids_l],
            fill_ratio=round(svc_l.stats.fill_ratio, 4),
            dispatches=svc_l.stats.dispatches,
            devices=1,
        ))
        rows.append(_latency_row(
            f"service_mesh/mesh_load{load}", "mesh", load, wall_m,
            [svc_m.results[r].latency_s for r in rids_m],
            fill_ratio=round(svc_m.stats.fill_ratio, 4),
            dispatches=svc_m.stats.dispatches,
            devices=svc_m.backend.describe()["devices"],
        ))

        # ---- the §6.5 parity contract ------------------------------------
        cut_equal = True
        for g, rl, rm in zip(graphs, rids_l, rids_m):
            ra, rb = svc_l.results[rl], svc_m.results[rm]
            cut_equal &= bool(
                ra.cut_value == rb.cut_value
                and np.array_equal(ra.assignment, rb.assignment)
            )
            if not ra.cached:  # and against solo core.solve on its knobs
                solo = solve(g, _cfg_from_plan(ra.plan), device=dev)
                cut_equal &= bool(ra.cut_value == solo.cut_value)
        rows.append({
            "name": f"service_mesh/parity_load{load}",
            "runtime_s": 0.0,
            "derived": (
                f"cut_equal={cut_equal};"
                f"mesh_over_local={wall_l / wall_m if wall_m else 0:.3f}x"
            ),
            "load": load,
            "cut_equal": cut_equal,
            "mesh_over_local": wall_l / wall_m if wall_m else 0.0,
        })

    # ---- async admission vs the synchronous loop --------------------------
    # max_inflight=1 reproduces the closed pump (dispatch, block, merge);
    # the async window overlaps host packing/merging with device batches.
    # Recalibration off so both loops plan identical knobs — with it on,
    # timing-dependent refits give the two runs different work and the
    # comparison measures the planner, not the loop.
    load = max(loads)
    graphs = request_mix(load, n_range, p, repeat_frac, seed)
    labels = tenant_mix(load, 2, seed)
    sync_wall = min(
        _service_run(graphs, labels, sla, max_inflight=1, **kw)[2]
        for _ in range(async_reps)
    )
    async_wall = min(
        _service_run(graphs, labels, sla, max_inflight=4, **kw)[2]
        for _ in range(async_reps)
    )
    sync_tput = load / sync_wall if sync_wall else 0.0
    async_tput = load / async_wall if async_wall else 0.0
    ratio = async_tput / sync_tput if sync_tput else float("inf")
    rows.append({
        "name": f"service_mesh/async_vs_sync_load{load}",
        "runtime_s": async_wall,
        "derived": (
            f"async={async_tput:.3f}rps;sync={sync_tput:.3f}rps;"
            f"ratio={ratio:.3f}x"
        ),
        "load": load,
        "async_throughput_rps": async_tput,
        "sync_throughput_rps": sync_tput,
        "async_over_sync": ratio,
        "async_ge_sync": bool(ratio >= 1.0),
    })

    if save and rows:
        path = write_bench_json(bench_path("service_mesh"), "service_mesh", rows, dev)
        print(f"# wrote {path}")
    return rows


def run_sla_soak(loads=(1.0, 4.0, 16.0, 64.0), requests=120, n_range=(10, 24),
                 p=0.3, seed=0, repeat_frac=0.4, tenants=2,
                 deadline_choices=(5.0, 15.0), floor_choices=(None, 6.0),
                 batch_slots=8, max_qubits=6, attainment_threshold=0.95,
                 save=True, device="cuda"):
    """§Perf C9: open-loop SLA soak → BENCH_service_sla.json.

    ``loads`` are offered arrival rates (requests/s); the *lowest* is the
    calibrated point, where the deadline-enforcing service is expected to
    hold attainment >= ``attainment_threshold``. Higher rates chart the
    degradation curve: shed/expired rates rise, attainment falls. Every
    row carries the boolean ``attainment_ge_threshold`` claim plus
    per-tenant attainment accounting.
    """
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.service import edge_capacity, make_backend
    from repro_torch.service.workload import (
        arrival_trace,
        latency_summary,
        run_soak_wall,
    )

    dev = resolve_device(device)
    # run every solver configuration the planner could pick once at the
    # scheduler's exact batch shapes, outside the soak: a first use (on the
    # card, a bucket's graph capture) landing mid-soak would be billed
    # against a 5-15 s deadline and read as an SLA miss of the *service*,
    # not of the measurement
    backend = make_backend(None, dev)
    probe = Planner(max_qubits=max_qubits, batch_slots=batch_slots)
    seen = set()
    for kn in probe.grid:
        qcfg = ParaQAOAConfig(
            n_qubits=kn.n_qubits, top_k=kn.top_k, merge_level=2,
            p_layers=kn.p_layers, opt_steps=kn.opt_steps,
            beam_width=kn.beam_width,
        ).qaoa_config()
        if qcfg in seen:
            continue
        seen.add(qcfg)
        g = Graph.erdos_renyi(kn.n_qubits, 0.8, seed=seed + 999)
        part = partition_for_solver(g, kn.n_qubits)
        edges, weights, masks = qaoa_mod.pad_subgraph_arrays(
            part.subgraphs[:1], qcfg.n_qubits,
            e_pad=edge_capacity(qcfg.n_qubits), n_rows=batch_slots, device=dev,
        )
        backend.solve_batch(qcfg, edges, weights, masks).bitstrings.cpu()

    # ... and the merges for the soak's actual graph mix (traces at every
    # rate share the same graphs — only arrival times rescale), so the
    # *first* load point alone is not billed every first use and the
    # degradation curve does not read backwards
    warm_svc = SolveService(ServiceConfig(
        batch_slots=batch_slots, max_qubits=max_qubits, recalibrate=False,
        enforce_deadlines=False, device=str(dev),
    ))
    for g in request_mix(requests, n_range, p, repeat_frac, seed):
        warm_svc.submit(g, SLA())
    warm_svc.drain()

    rows = []
    calibrated_rate = min(loads)
    for rate in loads:
        trace = arrival_trace(
            requests, rate, n_range, p, seed, repeat_frac=repeat_frac,
            tenants=tenants, deadline_choices=deadline_choices,
            floor_choices=floor_choices,
        )
        svc = SolveService(ServiceConfig(
            batch_slots=batch_slots, max_qubits=max_qubits, device=str(dev),
        ))  # recalibration on: enforcement uses the live cost model
        rids, wall = run_soak_wall(svc, trace)
        res = [svc.results[r] for r in rids]
        assert len(res) == len(trace)
        st = svc.stats
        assert st.terminal == len(trace), "request missing a terminal state"
        n_req = len(res)
        # §8: completed-request percentiles straight from the service's
        # obs histogram — the same stream `st.latency` accumulates live
        lat = latency_summary(svc)
        p50, p99 = lat["p50"], lat["p99"]
        att = st.attainment
        shed_rate = st.shed / n_req
        expired_rate = st.expired / n_req
        dg_rate = st.downgraded / max(st.completed, 1)
        rows.append({
            "name": f"service_sla/load{rate:g}rps",
            "runtime_s": wall,
            "derived": (
                f"attainment={att:.3f};shed={shed_rate:.3f};"
                f"expired={expired_rate:.3f};downgrade={dg_rate:.3f};"
                f"p50={p50:.3f}s;p99={p99:.3f}s"
            ),
            "mode": "sla_soak",
            "offered_rps": rate,
            "load": n_req,
            "throughput_rps": st.completed / wall if wall > 0 else 0.0,
            "p50_s": p50,
            "p99_s": p99,
            "attainment": round(att, 4),
            "shed_rate": round(shed_rate, 4),
            "expired_rate": round(expired_rate, 4),
            "downgrade_rate": round(dg_rate, 4),
            "downgrade_events": st.downgrade_events,
            "completed": st.completed,
            "shed": st.shed,
            "expired": st.expired,
            "attainment_threshold": attainment_threshold,
            "attainment_ge_threshold": bool(att >= attainment_threshold),
            "calibrated": bool(rate == calibrated_rate),
            "tenants": {t: s.as_dict() for t, s in st.tenants.items()},
        })

    if save and rows:
        path = write_bench_json(bench_path("service_sla"), "service_sla", rows, dev)
        print(f"# wrote {path}")
    return rows


SMOKE = {
    "run": dict(loads=(1, 4), n_range=(24, 40), p=0.2, deadline_s=10.0,
                batch_slots=8, save=False),
    "distributed": dict(loads=(2, 4), n_range=(24, 40), p=0.2, deadline_s=10.0,
                        batch_slots=8, max_qubits=8, async_reps=1, save=False),
    "sla_soak": dict(loads=(1.0, 3.0, 9.0), requests=24, save=False),
}


if __name__ == "__main__":
    import sys

    device = device_arg()
    smoke = "--smoke" in sys.argv
    if "--sla-soak" in sys.argv:
        emit(run_sla_soak(**(SMOKE["sla_soak"] if smoke else {}), device=device))
    elif "--distributed" in sys.argv:
        emit(run_distributed(**(SMOKE["distributed"] if smoke else {}), device=device))
    else:
        emit(run(**(SMOKE["run"] if smoke else {}), device=device))
