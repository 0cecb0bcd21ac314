"""One run of one cell: set-up, the measured window, the metrics and the
check.

Set-up makes the cell's pool of instances from the seed, binds the solver's
kernels (built into the checkout's ``build/kernels/`` by the first run)
and solves one warm-up instance of the cell's shapes. The warm-up takes
``WARM_STEPS`` Adam steps, not the configuration's: a step launches the
same kernels at the same shapes whichever step it is, and the rest of a
solve (cost tables, final evolve, top-K, merge) is the same whatever the
count. The window is a
closed loop: one instance at a time goes to
``repro_torch.core.paraqaoa.solve``, back to back, each the pool's next,
until the window's seconds have passed; the solve under way then ends and
counts. Each solve ends in the solver's own reads of the device, and the
loop synchronises the device after it all the same.

To judge the QAOA stage, the loop keeps what each solve returns as
``out.qaoa`` (the candidates' probabilities and ⟨C⟩ of every row), on the
device until the window has closed.

Every kernel that ``perfbench/counts/`` prices is launched inside
``core.qaoa.solve_batch_on_device``, and the window records the rows
(``edges.shape[0]``) of each of its calls, in order, as ``Window.batches``.
A round is one call of ``solve_batch_on_device`` on that round's rows: a
solve that runs its subgraphs in rounds makes one call a round, each
launching every kernel as often as the others do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import sys
import time
import traceback

import numpy as np
import torch

from perfbench.lib import check as check_mod
from perfbench.lib import generate, stats
from perfbench.lib.devtrace import DeviceTrace


WARM_STEPS = 2  # Adam steps of the warm-up solve


@dataclasses.dataclass
class Window:
    """What a metric reader reads: the cell's settings, each solve's stage
    timings, and in a traced run the device trace and the kernel launches."""

    config: dict
    rows: int  # subgraphs a solve (M)
    timings: list  # each solve's out.timings
    window_s: float
    trace: object = None  # devtrace.Reading
    launches: dict = None  # kernel launches over the window, by wrapper
    batches: list = dataclasses.field(default_factory=list)  # rows of each batch


@contextlib.contextmanager
def capture_batches(qaoa_mod, into: list):
    """Append the rows of each call of ``qaoa_mod.solve_batch_on_device`` to
    ``into`` (its callers look the name up in the module when they call)."""
    inner = qaoa_mod.solve_batch_on_device

    def counted(edges, *args, **kwargs):
        into.append(int(edges.shape[0]))
        return inner(edges, *args, **kwargs)

    qaoa_mod.solve_batch_on_device = counted
    try:
        yield
    finally:
        qaoa_mod.solve_batch_on_device = inner


def graph_of(Graph, inst):
    n, edges, weights = inst
    return Graph(n=n, edges=torch.from_numpy(edges), weights=torch.from_numpy(weights),
                 n_edges=int(edges.shape[0]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print):
    """Measure the cell; returns (result dict without ``correct``, checks).

    ``t_start`` is the process's first clock reading, ``log`` prints the
    lines that come before the result."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as trace_mod

    device = torch.device(device)
    cfg = ParaQAOAConfig(**spec.config)
    pool_size = int(spec.cell["pool"])
    t_pool = time.perf_counter()
    pool = [generate.instance(spec.traffic, seed, i, device) for i in range(pool_size)]
    graphs = [graph_of(Graph, inst) for inst in pool]
    warm = graph_of(Graph, generate.instance(spec.traffic, seed, -1, device))
    batches: list = []
    with capture_batches(qaoa_mod, batches):
        t_warm = time.perf_counter()
        solve(warm, dataclasses.replace(cfg, opt_steps=min(cfg.opt_steps, WARM_STEPS)),
              device=device)
        _sync(device)
        batches.clear()
        t_ready = time.perf_counter()
        setup_s = t_ready - t_start
        log(f"setup {setup_s:.3f} s: start and imports {t_pool - t_start:.3f}, pool of "
            f"{pool_size} {t_warm - t_pool:.3f}, warm-up solve {t_ready - t_warm:.3f}")

        gc.collect()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tracer = trace_mod.Tracer(record=True) if trace else None
        dev_trace = DeviceTrace() if trace else None
        outs, ends, failed = [], [], 0
        with (trace_mod.use_tracer(tracer) if trace else contextlib.nullcontext()):
            if trace:
                dev_trace.start()
            t0 = time.perf_counter()
            for i in range(pool_size + 1):
                if i == pool_size:
                    raise SystemExit(f"pool of {pool_size} exhausted within the window")
                try:
                    out = solve(graphs[i], cfg, device=device)
                    _sync(device)
                    outs.append((i, out))
                except Exception:  # a solve that fails counts, and the loop goes on
                    log(traceback.format_exc())
                    failed += 1
                ends.append(time.perf_counter())
                if ends[-1] - t0 >= seconds:
                    break
            if trace:
                dev_trace.stop()
        t1 = ends[-1]
    launches = ops.launch_counts() if trace else None
    memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if not outs:
        raise SystemExit(f"no solve of the window completed ({failed} failed)")

    done = len(outs)
    durations = np.diff([t0] + ends)
    log(f"solves {done} in {t1 - t0:.6f} s; per solve: min {durations.min():.6f} "
        f"median {stats.percentile(durations, 0.5):.6f} max {durations.max():.6f} s; "
        + "; ".join(f"{k} " + " ".join(f"{o.timings[k]:.4f}" for _, o in outs)
                    for k in ("partition_s", "solve_s", "merge_s", "refine_s")))

    window = Window(config=spec.config, rows=outs[0][1].partition.m,
                    timings=[o.timings for _, o in outs], window_s=t1 - t0,
                    batches=batches)
    if trace:
        window.trace = dev_trace.read(t0, t1, tracer.spans)
        window.launches = launches
        metrics = _per_layer(spec, window, log)
    else:
        cut_sum = sum(check_mod.cut(pool[i][1], pool[i][2], o.assignment) for i, o in outs)
        abs_w = sum(float(np.abs(pool[i][2].astype(np.float64)).sum()) for i, _ in outs)
        e2e = {"setup_s": setup_s, "tts_s": (t1 - t0) / done,
               "cut_ratio": cut_sum / abs_w, "peak_gib": memory_peak / 2**30}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}

    solved = [solved_of(pool[i], o) for i, o in outs]
    del outs, graphs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_mod.check(spec.config, spec.cell["limits"], int(spec.cell["qaoa_rows"]),
                             solved, seed, device)
    result = {"attempted": done + failed, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": spec.chips, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        tr = window.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = _breakdown(tr)
    return result, checks


def solved_of(inst, out) -> check_mod.Solved:
    """A solve's instance and what it returned, on the host, for the check."""
    n, edges, weights = inst
    part, res = out.partition, out.qaoa
    return check_mod.Solved(
        n=n, edges=edges, weights=weights,
        assignment=np.asarray(out.assignment, dtype=np.int8), value=float(out.cut_value),
        ranges=list(part.ranges),
        sub_edges=[g.edges[:g.n_edges].numpy() for g in part.subgraphs],
        sub_weights=[g.weights[:g.n_edges].numpy() for g in part.subgraphs],
        cross_edges=np.asarray(part.inter_edges), cross_weights=np.asarray(part.inter_weights),
        candidates=np.asarray(out.candidates), probs=res.probs.cpu().numpy(),
        expectation=res.expectation.cpu().numpy())


def _per_layer(spec, window: Window, log) -> dict:
    out = {}
    for m in spec.per_layer:
        value = importlib.import_module(f"perfbench.metrics.{m['name']}").read(window, log)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this


def _breakdown(tr) -> dict:
    by_op: dict = {}
    for name, _, d in tr.ops:
        by_op[name] = by_op.get(name, 0) + d
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:NAME_CHARS], v / 1e9] for k, v in top],
            "idle_gaps": [[label, s] for s, label in tr.gaps[:10]]}


def is_correct(result: dict, checks) -> bool:
    """No solve failed and every number of the check is within its limit."""
    return result["failed"] == 0 and all(v <= lim for _, v, lim in checks)


def foreign_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in sys.modules if m.split(".")[0] in banned)
