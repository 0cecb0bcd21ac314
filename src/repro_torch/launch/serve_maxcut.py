"""Max-Cut solve-service driver on the GPU: concurrent requests through
the batched scheduler (port of ``repro/launch/serve_maxcut.py``; the same
flags and lines, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve_maxcut --requests 8 \
      --n-min 40 --n-max 120 --deadline 30 --repeat-frac 0.25

  # route the packed buckets through solve_pool over a 4-shard `data`
  # mesh: every shard a row block of one batch on this card
  PYTHONPATH=src python -m repro_torch.launch.serve_maxcut --requests 8 --mesh data=4

  # two tenants with skewed traffic: per-tenant fairness accounting
  PYTHONPATH=src python -m repro_torch.launch.serve_maxcut --requests 8 --tenants 2

  # anytime streaming: print the best-known cut after every merge level
  PYTHONPATH=src python -m repro_torch.launch.serve_maxcut --requests 2 --stream

  # the plain PyTorch versions on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve_maxcut --requests 4 \
      --n-min 20 --n-max 40 --qubits 6 --device cpu
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve_maxcut",
        description="Serve a batch of concurrent Max-Cut solve requests "
        "through the cross-request batching scheduler (SLA planner + "
        "canonical-graph result cache + anytime merge stream).",
    )
    ap.add_argument("--requests", type=int, default=8,
                    help="number of concurrent solve requests to admit")
    ap.add_argument("--n-min", type=int, default=40,
                    help="smallest request vertex count")
    ap.add_argument("--n-max", type=int, default=120,
                    help="largest request vertex count")
    ap.add_argument("--p", type=float, default=0.15,
                    help="Erdős-Rényi edge probability of the request mix")
    ap.add_argument("--seed", type=int, default=0,
                    help="request-mix seed (runs are seed-stable)")
    ap.add_argument("--repeat-frac", type=float, default=0.25,
                    help="fraction of requests that repeat an earlier graph "
                    "under a random vertex relabeling (exercises the "
                    "canonical-graph cache)")
    ap.add_argument("--problem", choices=("maxcut", "qubo", "mis"),
                    default="maxcut",
                    help="problem family of the request mix: Max-Cut "
                    "graphs, random QUBOs (quadratic + linear terms), or "
                    "penalty-encoded maximum-independent-set instances — "
                    "all served through the same diagonal-cost oracle")
    ap.add_argument("--weights", choices=("unit", "uniform", "spin"),
                    default="unit",
                    help="edge-weight family of the instance topology: "
                    "unit weights, uniform(0.1,1) weights, or ±1 "
                    "spin-glass couplings")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLA deadline in seconds (omit for "
                    "best-quality planning)")
    ap.add_argument("--floor-quality", type=float, default=None,
                    help="per-request accuracy floor (planner quality "
                    "scale): deadline downgrades never re-plan below it, "
                    "and admission sheds when even the floor plan is "
                    "predicted to miss the deadline (DESIGN.md §6.6)")
    ap.add_argument("--no-enforce-sla", action="store_true",
                    help="disable §6.6 deadline enforcement (downgrade/"
                    "shed/expire); predicted-late requests are admitted "
                    "and served late, as in the pre-enforcement service")
    ap.add_argument("--target-quality", type=float, default=None,
                    help="per-request accuracy-proxy target (planner "
                    "quality scale); the planner meets it at minimum "
                    "predicted cost")
    ap.add_argument("--qubits", type=int, default=12,
                    help="hardware qubit budget cap for the SLA planner")
    ap.add_argument("--batch", type=int, default=16,
                    help="solver batch slots per dispatch (cross-request)")
    ap.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                    help="route packed buckets through solve_pool over this "
                    "mesh, e.g. 'data=4' (axes: pod/data; cuts stay "
                    "bit-identical to the single-device service). In one "
                    "process every shard is a row block on --device; under "
                    "a launcher (WORLD_SIZE > 1) one shard a rank. Omit for "
                    "the single-device backend")
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenants the request mix is (skew-)"
                    "assigned to; the dispatcher round-robins slots across "
                    "tenants and reports per-tenant stats")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="solver batches in flight before the event loop "
                    "blocks on the oldest (async admission window)")
    ap.add_argument("--no-recalibrate", action="store_true",
                    help="freeze the planner's cost model at the card's "
                    "committed calibration instead of streaming "
                    "served-request timings back into it")
    ap.add_argument("--cache-capacity", type=int, default=256,
                    help="result-cache entries (LRU beyond this)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the canonical-graph result cache")
    ap.add_argument("--stream", action="store_true",
                    help="anytime mode: print the best-known cut after "
                    "every merge level of every request")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="export the request-to-kernel span trace here "
                    "(tracing is off unless this is set)")
    ap.add_argument("--trace-format", choices=("jsonl", "chrome"),
                    default="jsonl",
                    help="trace export format: 'jsonl' (one span per "
                    "line) or 'chrome' (Perfetto-loadable trace events)")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="export the service metrics snapshot here "
                    "(counters, gauges, latency histograms)")
    ap.add_argument("--metrics-format", choices=("json", "prom"),
                    default="json",
                    help="metrics export format: JSON snapshot or "
                    "Prometheus text exposition")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu' "
                    "for the plain PyTorch versions")
    return ap


def run(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import SLA, ServiceConfig, SolveService
    from repro_torch.service.workload import problem_mix, tenant_mix

    mesh_spec = parse_mesh_spec(args.mesh) if args.mesh else None
    requests = problem_mix(
        args.requests, (args.n_min, args.n_max), args.p,
        args.repeat_frac, args.seed,
        problem=args.problem, weights=args.weights,
    )
    tenants = tenant_mix(args.requests, args.tenants, args.seed)

    # tracing is enabled only when an export path is requested; the
    # tracer shares the service's clock (the default here)
    tracer = Tracer(record=True) if args.trace_out else None
    svc = SolveService(
        ServiceConfig(
            batch_slots=args.batch,
            cache_capacity=args.cache_capacity,
            enable_cache=not args.no_cache,
            max_qubits=args.qubits,
            mesh=mesh_spec,
            max_inflight=args.max_inflight,
            recalibrate=not args.no_recalibrate,
            enforce_deadlines=not args.no_enforce_sla,
            device=args.device,
        ),
        tracer=tracer,
    )
    sla = SLA(deadline_s=args.deadline, target_quality=args.target_quality,
              floor_quality=args.floor_quality)

    def on_update(rid, level, n_levels, cut):
        print(f"[serve_maxcut]   req {rid} level {level}/{n_levels}: "
              f"best-known cut {cut:.0f}")

    t0 = time.perf_counter()
    rids = [
        svc.submit(g, sla, stream=args.stream,
                   on_update=on_update if args.stream else None,
                   tenant=tenant)
        for g, tenant in zip(requests, tenants)
    ]
    svc.drain()
    wall = time.perf_counter() - t0

    for g, rid in zip(requests, rids):
        r = svc.results[rid]
        if r.status != "completed":
            # shed at admission (floor plan predicted late) or expired
            # pre-dispatch — no cut was served
            print(f"[serve_maxcut] req {rid} ({r.tenant}): n={g.n} "
                  f"{r.status.upper()} after {r.latency_s:.2f}s")
            continue
        kn = r.plan.knobs
        src = "cache" if r.cached else (
            f"N={kn.n_qubits} K={kn.top_k} T={kn.opt_steps} W={kn.beam_width}"
        )
        tail = f" [{r.downgrades} downgrade(s)]" if r.downgrades else ""
        integral = args.problem == "maxcut" and args.weights == "unit"
        val = f"{r.cut_value:.0f}" if integral else f"{r.cut_value:.2f}"
        print(f"[serve_maxcut] req {rid} ({r.tenant}): n={g.n} "
              f"value={val} latency={r.latency_s:.2f}s ({src})"
              f"{tail}")

    st = svc.stats
    p50 = st.latency.percentile(0.5)
    print(f"[serve_maxcut] {len(rids)} requests in {wall:.2f}s "
          f"({len(rids) / wall:.2f} req/s), p50 latency {p50:.2f}s")
    if args.deadline is not None and not args.no_enforce_sla:
        print(f"[serve_maxcut] sla: attainment={st.attainment:.3f} "
              f"completed={st.completed} shed={st.shed} "
              f"expired={st.expired} downgrades={st.downgrade_events}")
    print(f"[serve_maxcut] backend: {svc.backend.describe()}")
    print(f"[serve_maxcut] batching: {svc.stats.as_dict()}")
    print(f"[serve_maxcut] cache: {svc.cache.stats.as_dict()}")
    if not args.no_recalibrate:
        print(f"[serve_maxcut] recalibration: "
              f"{svc.planner.calibration.as_dict()}")
    if args.trace_out:
        svc.trace.export(args.trace_out, args.trace_format)
        print(f"[serve_maxcut] trace ({args.trace_format}, "
              f"{len(svc.trace.spans)} spans): {args.trace_out}")
    if args.metrics_out:
        reg = svc.metrics_registry()
        with open(args.metrics_out, "w") as f:
            f.write(reg.to_json() if args.metrics_format == "json"
                    else reg.to_prometheus())
        print(f"[serve_maxcut] metrics ({args.metrics_format}): "
              f"{args.metrics_out}")
    return svc


if __name__ == "__main__":
    run()
