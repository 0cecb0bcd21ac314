"""hot-nondeterminism: clock and RNG reads in code that must replay
(port of ``repro/analysis/rules/determinism.py``).

Four protected regions, the reference's with the port's names:

  1. **Replayed regions** (`Project.replayed`: the body of every
     ``with torch.cuda.graph(...)`` block, the callable of
     `torch.utils.checkpoint.checkpoint`, `make_graphed_callables` and
     `torch.compile`, and the functions they reach): a host value read
     while the region is captured is baked into every replay, and a
     checkpointed body runs twice (forward and recomputation), so a
     second read disagrees with the first. `time.*`, `datetime.*` and
     stdlib `random.*` are banned there.

  2. **The scheduler's decision path** (`repro_torch.service.scheduler`):
     admission, bucket choice and merge order replay from event logs under
     a `VirtualClock`; a `random.random()` tiebreak or a `time.time()`
     decision breaks that. `time.perf_counter*` / `time.monotonic*` stay
     allowed: they feed latency accounting only.

  3. **The observability package** (`repro_torch.obs.*`): timestamps come
     through the injectable clock (`repro_torch.obs.clock.default_clock`)
     so virtual-clock soaks stay bit-deterministic with tracing on; every
     `time.*` / `datetime.*` read is banned, the monotonic clocks
     included, except in `repro_torch.obs.clock` itself.

  4. **The measurement path** (`repro_torch.kernels.tuning`): the sweep's
     timings feed the committed tuning table, so they go through the
     injectable clock too.

In all four, a read of torch's global RNG without ``generator=``
(`torch.rand`, `randn`, `randint`, `randperm`, `bernoulli`,
`multinomial`, and their ``*_like`` forms) is banned: the port's rule is
an explicit `torch.Generator` seeded by the caller, and the global
generator is shared state that any other caller advances.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ModuleInfo, Project
from repro_torch.analysis.rules.host_read import walk_shallow

RULE_ID = "hot-nondeterminism"

DETERMINISTIC_PATHS = ("repro_torch.service.scheduler",)
OBS_PACKAGE = "repro_torch.obs"
OBS_CLOCK_MODULE = "repro_torch.obs.clock"
MEASUREMENT_PATHS = ("repro_torch.kernels.tuning",)

_ALLOWED_CLOCKS = {
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
}
_CLOCK_READS = {
    "time.time", "time.time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
_TORCH_RNG = {
    f"torch.{name}" for name in (
        "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
        "normal", "poisson", "rand_like", "randn_like", "randint_like",
    )
}
_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _banned(qual: str, call: ast.Call, strict_clock: bool) -> str | None:
    """Reason string when ``call`` (to ``qual``) is a nondeterministic
    read, else None; ``strict_clock`` bans the monotonic clocks too."""
    if qual == "random" or qual.startswith("random."):
        return f"stdlib RNG '{qual}'"
    if qual in _TORCH_RNG and not any(k.arg == "generator"
                                      for k in call.keywords):
        return f"torch's global RNG '{qual}' (no generator=)"
    if qual in _CLOCK_READS:
        return f"wall-clock read '{qual}'"
    if strict_clock and qual.startswith("time.") and qual.count(".") == 1:
        return f"host clock read '{qual}'"
    return None


class HotNondeterminismRule:
    id = RULE_ID
    summary = (
        "no time/datetime/stdlib-random reads, nor torch's global RNG, in "
        "replayed regions, the scheduler, obs/ or the tuning sweep"
    )

    def check(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        seen: set[tuple[str, int, int]] = set()

        def flag(mod: ModuleInfo, node: ast.Call, message: str,
                 symbol: str = ""):
            key = (mod.path, node.lineno, node.col_offset)
            if key not in seen:
                seen.add(key)
                findings.append(mod.finding(self.id, node, message,
                                            symbol=symbol))

        replay_msg = ("inside a replayed region: a captured graph bakes the "
                      "value into every replay and a checkpointed body reads "
                      "it again when it recomputes; hoist the read out or "
                      "pass an explicit torch.Generator")
        for fn in project.functions():
            if fn.node not in project.replayed or \
                    not isinstance(fn.node, _FuncNode):
                continue
            mod = fn.module
            symbol = fn.qualname[len(mod.modname) + 1:]
            for node in walk_shallow(fn.node):
                if isinstance(node, ast.Call):
                    reason = _banned(mod.qualify(node.func) or "", node, True)
                    if reason:
                        flag(mod, node, f"{reason} {replay_msg}", symbol)
        for mod, block, fn in project.capture_blocks:
            symbol = fn.qualname[len(mod.modname) + 1:] if fn else ""
            for stmt in block.body:
                for node in [stmt, *walk_shallow(stmt)]:
                    if isinstance(node, ast.Call):
                        reason = _banned(mod.qualify(node.func) or "", node,
                                         True)
                        if reason:
                            flag(mod, node, f"{reason} {replay_msg}", symbol)

        for mod in project.modules:
            if mod.modname not in DETERMINISTIC_PATHS:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                qual = mod.qualify(node.func) or ""
                if qual in _ALLOWED_CLOCKS:
                    continue
                reason = _banned(qual, node, False)
                if reason:
                    flag(mod, node,
                         f"{reason} in deterministic scheduler path "
                         f"'{mod.modname}': admission and dispatch decisions "
                         "must replay from event logs; use time.perf_counter "
                         "for observability or thread seeds explicitly")

        for mod in project.modules:
            in_obs = (mod.modname == OBS_PACKAGE
                      or mod.modname.startswith(OBS_PACKAGE + "."))
            in_measure = mod.modname in MEASUREMENT_PATHS
            if not (in_obs or in_measure) or mod.modname == OBS_CLOCK_MODULE:
                continue
            kind = "observability" if in_obs else "measurement-path"
            why = ("so virtual-clock soaks stay bit-deterministic with "
                   "tracing on" if in_obs else
                   "so the block-shape sweep is replayable and mockable")
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                reason = _banned(mod.qualify(node.func) or "", node, True)
                if reason:
                    flag(mod, node,
                         f"{reason} in {kind} module '{mod.modname}': "
                         "timestamps must flow through the injectable clock "
                         f"('{OBS_CLOCK_MODULE}.default_clock') and "
                         f"randomness through a seeded generator, {why}")
        return findings


RULE = HotNondeterminismRule()
