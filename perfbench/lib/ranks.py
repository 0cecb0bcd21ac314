"""A run over the cards of one host: one rank a card, each a process of
the ``spawn`` context, joined over NCCL by the solver's own
``core.axis.join_from_env`` (gloo on the CPU), with a gloo group beside
it for the harness's own messages (`bench.measure`).

The parent starts the ranks and touches no card. Rank 0 sends it the
result line and the answers once the ranks have measured and rank 0 has
checked; the parent prints them only when every rank has exited 0.
A rank that exits otherwise, or a run that outlasts ``--seconds`` by more
than `ALLOWANCE_S`, ends the run: the parent kills every rank first, so
none is left waiting in a collective, and prints no result.
"""

from __future__ import annotations

import ctypes
import multiprocessing
import os
import signal
import socket
import sys
import time

# seconds a run over cards may take beyond --seconds: the spawn, the
# imports, the NCCL join, a first run's kernel build, the warm-up and the
# check (about 120 s on four H100s). With a 51 s window, ranks that hang
# are ended 351 s after the start.
ALLOWANCE_S = 300.0
POLL_S = 0.1


def launch(spec, seed: int, seconds: float, trace: bool, device_type: str, t_start: float,
           allowance: float = ALLOWANCE_S, target=None):
    """Run the cell on ``spec.chips`` ranks; returns (exit code, rank 0's
    (result line, answers) or None). ``device_type`` is ``"cuda"``
    (rank r on ``cuda:r``) or ``"cpu"``; ``target`` stands in for
    `rank_main` in a test."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    port = _free_port()
    procs = []
    for rank in range(spec.chips):
        env = {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(spec.chips),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(ctx.Process(target=target or rank_main, name=f"rank {rank}",
                                 args=(spec, seed, seconds, trace, device_type, t_start, env,
                                       send if rank == 0 else None)))
    deadline = t_start + seconds + allowance
    outcome, reading = None, True
    try:
        for p in procs:
            p.start()
        send.close()
        while True:
            if reading and recv.poll(POLL_S):
                try:
                    outcome = recv.recv()
                except EOFError:  # rank 0 has exited
                    reading = False
            elif not reading:
                time.sleep(POLL_S)
            codes = [p.exitcode for p in procs]
            bad = [f"{p.name} exited {c}" for p, c in zip(procs, codes) if c not in (None, 0)]
            if bad:
                _log(f"the run fails: {', '.join(bad)}")
                return 1, None
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() > deadline:
                _log(f"the run fails: still running {seconds + allowance:.0f} s after its start")
                return 1, None
        if outcome is None and reading and recv.poll():  # sent after the last poll
            try:
                outcome = recv.recv()
            except EOFError:
                pass
        if outcome is None:
            _log("the run fails: rank 0 sent no result")
            return 1, None
        return 0, outcome
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        recv.close()
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()  # the spawn context started it


def rank_main(spec, seed, seconds, trace, device_type, t_start, env, conn):
    """One rank: join the ranks, measure its card, and on rank 0 check the
    window and send the outcome to the parent."""
    _die_with_parent()
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    from perfbench.lib import bench
    from repro_torch.core.axis import join_from_env

    short = bench.cuda_shortfall(spec.chips) if device_type == "cuda" else None
    if short:
        raise SystemExit(short)
    rank = int(env["RANK"])
    # each rank the host's cores that a run on one card of the host has
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(env["WORLD_SIZE"])))
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    join_from_env(device)
    group = dist.new_group(backend="gloo")

    def log(line):
        _log(line if rank == 0 else f"rank {rank}: {line}")

    measured = bench.measure(spec, seed, seconds, trace, device, t_start, log=log, group=group)
    dist.destroy_process_group()  # every rank at once, after the last message
    bench.refuse_foreign()  # the window has closed: what this rank's solves loaded
    if measured is None:
        return
    result, solved = measured
    checks = bench.judge(spec, solved, seed, device)
    bench.refuse_foreign()
    conn.send((bench.result_line(result, checks), [s.assignment for s in solved]))
    conn.close()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent():
    """Have the kernel end this process when the parent ends (Linux), so no
    rank outlives a parent that was killed."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _log(line):
    print(line, file=sys.stderr, flush=True)
