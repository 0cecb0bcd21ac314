"""reprolint for the port: an AST invariant checker for `repro_torch`.

A port of the JAX package's linter (``repro/analysis/``), pure stdlib
``ast``: it imports neither torch nor JAX, nor anything of the code it
reads. Five rules, each descended from a bug one of the two packages
shipped, or a contract a test held by hand:

  cache-key           A program cache keys the dispatch state it captures.
                      Torch hazard: a CUDA graph replays the
                      block-shape geometry (`tuning.state()`) of its
                      capture. Descends from the reference's
                      `_solve_pool_program` key, which missed the active
                      implementation, and the port's bucket graphs,
                      once keyed without the tuning state.
  dispatch-purity     Kernel modules (the wrappers, ``ref``, ``_build``)
                      only through `kernels.ops`. Torch hazard: a direct
                      call skips the launch counts and the ledger's
                      route. Descends from the reference's
                      dispatch chokepoint tests; the service's backend
                      once imported ``_build`` for its launch counts.
  host-read           Nothing between a dispatch and its harvest reads the
                      card: no ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                      ``.numpy()``, host casts, tensor-valued ``if`` /
                      ``while`` or `torch.cuda.synchronize` in a replayed
                      region, `qaoa.solve_subgraph_batch`,
                      `backend.solve_graphed` or the decode loop. Torch
                      hazard: such a read silently synchronises. Descends
                      from the solve service's dispatch that blocked on
                      the card (the
                      reference's ``tracer-hazard`` has no torch
                      counterpart; its taint analysis lives on here).
  collective-axis     A `torch.distributed` collective names its group (a
                      parameter, ``*.group``, ``mesh.get_group(<axis>)``).
                      Torch hazard: without one it reduces over the whole
                      world, silently. Descends from the reference's
                      unbound ``lax`` axis names.
  hot-nondeterminism  No clock, stdlib RNG or global torch RNG read in a
                      replayed region (graph capture, checkpointed body),
                      the scheduler, ``obs/`` or the tuning sweep. Torch
                      hazard: a capture bakes the value in, a checkpointed
                      body reads it twice. Descends from the reference's
                      rule of the same name.

Run it:    python -m repro_torch.analysis [paths] [--format json]
           (paths default to src/repro_torch; exit 0 clean, 1 findings,
           2 usage)
Suppress:  # reprolint: disable=<rule>         (same line, with a reason)
           # reprolint: disable-file=<rule>    (whole file)
Baseline:  src/repro_torch/analysis/baseline.json (empty: every finding is
           fixed in code or suppressed inline with a reason)
"""

from repro_torch.analysis.engine import (
    Finding,
    ModuleInfo,
    Project,
    Report,
    collect_files,
    load_baseline,
    run,
    run_on_sources,
    write_baseline,
)
from repro_torch.analysis.rules import ALL_RULES, get_rules, rule_ids

__all__ = [
    "ALL_RULES",
    "Finding",
    "ModuleInfo",
    "Project",
    "Report",
    "collect_files",
    "get_rules",
    "load_baseline",
    "rule_ids",
    "run",
    "run_on_sources",
    "write_baseline",
]
