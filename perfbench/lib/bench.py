"""One run of one cell: set-up, the measured window, the metrics and the
check.

Set-up makes the cell's pool of instances from the seed, binds the solver's
kernels (built into the checkout's ``build/kernels/`` by the first run)
and solves one warm-up instance of the cell's shapes. The warm-up takes
``WARM_STEPS`` Adam steps, not the configuration's: a step launches the
same kernels at the same shapes whichever step it is, and the rest of a
solve (cost tables, final evolve, top-K, merge) is the same whatever the
count. The window is a closed loop: one instance at a time goes to
``repro_torch.core.paraqaoa.solve`` (or, where the configuration names a
mesh, ``core.distributed.solve_distributed`` over it), back to back, each
the pool's next, until the window's seconds have passed; the solve under
way then ends and counts. Each solve ends in the solver's own reads of the
device, and the loop synchronises the device after it all the same.

Over cards (a mesh, one rank a card, started by ``perfbench/lib/ranks.py``)
every rank makes the same pool and the same warm-up from the seed, and all
solve the same instance at once, as the solve's collectives need. After
each solve rank 0's decision to close the window goes to every rank as one
scalar over a gloo group, so that all stop after the same solve. A solve
that raises fails the run there, since the other ranks would wait in a
collective for ever; on one card it counts as failed and the loop goes on.
After the window each rank sends rank 0 what it measured on its own card
(`Card`) over the gloo group, which synchronises no card. The readings are
taken over the list of cards, a list of one on one card; the spans, the
answers and the check are rank 0's.

To judge the QAOA stage, the loop keeps what each solve returns as
``out.qaoa`` (the candidates' probabilities and ⟨C⟩ of every row), on the
device until the window has closed. A solve over a mesh returns none; there
the loop keeps what ``core.distributed.solve_pool`` returned, the pool's
result gathered from every rank, where it holds every row. A solve with
neither counts under the check's ``qaoa_missing``.

Every kernel that ``perfbench/counts/`` prices is launched inside
``core.qaoa.solve_batch_on_device``, and the window records the rows
(``edges.shape[0]``) of each of its calls on the card, in order, as
``Card.batches``. A round is one call of ``solve_batch_on_device`` on that
round's rows: a solve that runs its subgraphs in rounds makes one call a
round, each launching every kernel as often as the others do.
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
import torch.distributed as dist

from perfbench.lib import check as check_mod
from perfbench.lib import generate, stats
from perfbench.lib.devtrace import DeviceTrace


WARM_STEPS = 2  # Adam steps of the warm-up solve


@dataclasses.dataclass
class Card:
    """What one rank measured on its own card over its own window."""

    peak: int  # bytes: the card's max_memory_allocated over the window
    batches: list  # rows of each call of solve_batch_on_device, in order
    launches: dict = None  # traced: kernel launches over the window, by wrapper
    trace: object = None  # traced: devtrace.Reading of the card's window


@dataclasses.dataclass
class Window:
    """What a metric reader reads: the cell's settings, each solve's stage
    timings (rank 0's), and each card's readings, in rank order."""

    config: dict
    rows: int  # subgraphs a solve (M)
    timings: list  # each solve's out.timings
    window_s: float
    chips: int = 1
    cards: list = dataclasses.field(default_factory=list)  # Card of each rank


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


@contextlib.contextmanager
def capture_stages(dist_mod, into: list):
    """Append what each call of ``dist_mod.solve_pool`` returns to ``into``:
    the pool's QAOA result of its rows, gathered from every rank (its
    caller looks the name up in the module when it calls)."""
    inner = dist_mod.solve_pool

    def kept(*args, **kwargs):
        res = inner(*args, **kwargs)
        into.append(res)
        return res

    dist_mod.solve_pool = kept
    try:
        yield
    finally:
        dist_mod.solve_pool = inner


def graph_of(Graph, inst):
    n, edges, weights = inst
    return Graph(n=n, edges=torch.from_numpy(edges), weights=torch.from_numpy(weights),
                 n_edges=int(edges.shape[0]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print):
    """Measure the cell in this process and check it; returns (result dict
    without ``correct``, checks).

    ``t_start`` is the process's first clock reading, ``log`` prints the
    lines that come before the result."""
    result, solved = measure(spec, seed, seconds, trace, device, t_start, log)
    return result, judge(spec, solved, seed, device)


def measure(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
            log=print, group=None):
    """Set up, run the window and take its readings: (result dict without
    ``correct``, the window's solves as `check.Solved`) on one card or on
    rank 0; None on the other ranks. ``group`` is the gloo group of the
    ranks of a run over cards, None on one card."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as trace_mod

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = ParaQAOAConfig(**spec.config)

    def solve_one(graph, cfg):
        if spec.mesh is None:
            return solve(graph, cfg, device=device)
        return dist_mod.solve_distributed(graph, cfg, spec.mesh, merge_mode=spec.merge_mode,
                                          device=device)

    pool_size = int(spec.cell["pool"])
    t_pool = time.perf_counter()
    pool = [generate.instance(spec.traffic, seed, i, device) for i in range(pool_size)]
    graphs = [graph_of(Graph, inst) for inst in pool]
    warm = graph_of(Graph, generate.instance(spec.traffic, seed, -1, device))
    batches, stages = [], []
    with capture_batches(qaoa_mod, batches), capture_stages(dist_mod, stages):
        t_warm = time.perf_counter()
        solve_one(warm, dataclasses.replace(cfg, opt_steps=min(cfg.opt_steps, WARM_STEPS)))
        _sync(device)
        batches.clear()
        t_ready = time.perf_counter()
        setup_s = t_ready - t_start
        log(f"setup {setup_s:.3f} s: start and imports {t_pool - t_start:.3f}, pool of "
            f"{pool_size} {t_warm - t_pool:.3f}, warm-up solve {t_ready - t_warm:.3f}")

        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        tracer = trace_mod.Tracer(record=True) if trace else None
        dev_trace = DeviceTrace() if trace else None
        outs, ends, failed = [], [], 0
        with (trace_mod.use_tracer(tracer) if trace else contextlib.nullcontext()):
            if trace:
                dev_trace.start()
            if group is not None:
                dist.barrier(group=group)  # the ranks start the window together
            t0 = time.perf_counter()
            for i in range(pool_size + 1):
                if i == pool_size:
                    raise SystemExit(f"pool of {pool_size} exhausted within the window")
                stages.clear()
                try:
                    out = solve_one(graphs[i], cfg)
                    _sync(device)
                    outs.append((i, out, list(stages)))
                except Exception:
                    if group is not None:  # the other ranks would wait in a collective
                        raise
                    log(traceback.format_exc())  # one card counts it, and the loop goes on
                    failed += 1
                ends.append(time.perf_counter())
                if _rank0_says(ends[-1] - t0 >= seconds, group):
                    break
            if trace:
                dev_trace.stop()
        t1 = ends[-1]
    card = Card(peak=torch.cuda.max_memory_allocated(device) if cuda else 0, batches=batches,
                launches=ops.launch_counts() if trace else None,
                trace=dev_trace.read(t0, t1, tracer.spans) if trace else None)
    cards = _gather(card, group)
    if cards is None:
        return None
    if not outs:
        raise SystemExit(f"no solve of the window completed ({failed} failed)")

    done = len(outs)
    durations = np.diff([t0] + ends)
    log(f"solves {done} in {t1 - t0:.6f} s; per solve: min {durations.min():.6f} "
        f"median {stats.percentile(durations, 0.5):.6f} max {durations.max():.6f} s; "
        + "; ".join(f"{k} " + " ".join(f"{o.timings[k]:.4f}" for _, o, _ in outs)
                    for k in ("partition_s", "solve_s", "merge_s", "refine_s")))
    log(f"memory peak of each card: {[c.peak for c in cards]} bytes")
    dev = device_of(cards, spec.chips, device)

    window = Window(config=spec.config, rows=outs[0][1].partition.m,
                    timings=[o.timings for _, o, _ in outs], window_s=t1 - t0,
                    chips=spec.chips, cards=cards)
    if trace:
        metrics = _per_layer(spec, window, log)
    else:
        cut_sum = sum(check_mod.cut(pool[i][1], pool[i][2], o.assignment) for i, o, _ in outs)
        abs_w = sum(float(np.abs(pool[i][2].astype(np.float64)).sum()) for i, _, _ in outs)
        e2e = {"setup_s": setup_s, "tts_s": (t1 - t0) / done,
               "cut_ratio": cut_sum / abs_w, "peak_gib": dev["memory_peak_bytes"] / 2**30}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}

    solved = [solved_of(pool[i], o, kept) for i, o, kept in outs]
    del outs, graphs, stages
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result = {"attempted": done + failed, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = _breakdown(cards)
    return result, solved


def device_of(cards: list, chips: int, device) -> dict:
    """The result's ``device``: the fullest card's peak and, in a traced
    run, the mean over the cards of each one's busy and window seconds."""
    cuda = device.type == "cuda"
    out = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(max(c.peak for c in cards))}
    if cards[0].trace is not None:
        out.update(busy_s=_mean(c.trace.busy_s for c in cards),
                   window_s=_mean(c.trace.window_s for c in cards))
    return out


def judge(spec, solved: list, seed: int, device) -> list:
    """The check of the window's solves: [(name, number, limit)]."""
    return check_mod.check(spec.config, spec.cell["limits"], int(spec.cell["qaoa_rows"]),
                           solved, seed, torch.device(device))


def stage_of(out, stages):
    """A solve's QAOA stage: ``out.qaoa``, or where the solve does not
    return it (a solve over a mesh), the one result of the solver pool
    kept in ``stages`` if it holds every row; else None."""
    if out.qaoa is not None:
        return out.qaoa
    if len(stages) == 1 and stages[0].probs.shape[0] == out.partition.m:
        return stages[0]
    return None


def _rank0_says(flag: bool, group) -> bool:
    """Rank 0's ``flag`` on every rank, as one scalar over ``group``; the
    flag itself on one card."""
    if group is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(t, src=0, group=group)
    return bool(t.item())


def _gather(card, group):
    """Every rank's `Card` on rank 0, in rank order, and None on the others;
    on one card a list of one."""
    if group is None:
        return [card]
    cards = [None] * dist.get_world_size(group) if dist.get_rank(group) == 0 else None
    dist.gather_object(card, cards, dst=0, group=group)
    return cards


def _mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def solved_of(inst, out, stages=()) -> check_mod.Solved:
    """A solve's instance and what it returned, on the host, for the check,
    with its QAOA stage as `stage_of` finds it (``stages``: what the pool
    returned during the solve); without one the probabilities and ⟨C⟩ are
    None, and the check counts the solve under ``qaoa_missing``."""
    n, edges, weights = inst
    part = out.partition
    res = stage_of(out, stages)
    return check_mod.Solved(
        n=n, edges=edges, weights=weights,
        assignment=np.asarray(out.assignment, dtype=np.int8), value=float(out.cut_value),
        ranges=list(part.ranges),
        sub_edges=[g.edges[:g.n_edges].numpy() for g in part.subgraphs],
        sub_weights=[g.weights[:g.n_edges].numpy() for g in part.subgraphs],
        cross_edges=np.asarray(part.inter_edges), cross_weights=np.asarray(part.inter_weights),
        candidates=np.asarray(out.candidates),
        probs=None if res is None else res.probs.cpu().numpy(),
        expectation=None if res is None else res.expectation.cpu().numpy())


def _per_layer(spec, window: Window, log) -> dict:
    out = {}
    for m in spec.per_layer:
        value = importlib.import_module(f"perfbench.metrics.{m['name']}").read(window, log)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this


def _breakdown(cards) -> dict:
    """The ten device operations that took most time, summed over the cards,
    and the ten longest idle gaps of all the cards, each named by the span
    open on its rank's host, with ``@<card>`` where there is more than one."""
    by_op: dict = {}
    for c in cards:
        for name, _, d in c.trace.ops:
            by_op[name] = by_op.get(name, 0) + d
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    many = len(cards) > 1
    gaps = sorted(((s, f"{label}@{r}" if many else label)
                   for r, c in enumerate(cards) for s, label in c.trace.gaps), reverse=True)
    return {"device_ops": [[k[:NAME_CHARS], v / 1e9] for k, v in top],
            "idle_gaps": [[label, s] for s, label in gaps[:10]]}


def is_correct(result: dict, checks) -> bool:
    """No solve failed and every number of the check is within its limit."""
    return result["failed"] == 0 and all(v <= lim for _, v, lim in checks)


def result_line(result: dict, checks) -> dict:
    """The run's last line: ``correct``, the result, and each number of the
    check with its limit, last."""
    return {"correct": is_correct(result, checks), **result,
            "checks": {name: {"value": value, "limit": limit} for name, value, limit in checks}}


def cuda_shortfall(chips: int) -> str | None:
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return None if found >= chips else f"needs {chips} CUDA device(s); found {found}"


def refuse_foreign() -> None:
    """End the run, naming them, where JAX or the JAX package is loaded in
    this process."""
    found = foreign_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {', '.join(found)}")


def foreign_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in sys.modules if m.split(".")[0] in banned)
