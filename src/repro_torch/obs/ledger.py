"""Build ledger: every CUDA source built or loaded and every kernel
dispatch, recorded (port of ``repro/obs/ledger.py``, which is
stdlib-only).

  - ``build``   — `kernels._build.build_all` compiled a ``csrc/<name>.cu``
    with nvcc, or loaded the library an earlier build left: one event per
    source, its duration the compile (or the load), its key the source
    hash. The libraries stay loaded for the process, so later calls
    record nothing.
  - ``compile`` — the reference's first call of a cached program at a
    novel shape signature. The port has no per-shape compile (a kernel is
    built once for every shape), so nothing records one and the count
    stays 0.
  - ``op``      — a `kernels.ops` entry point dispatched, deduplicated per
    (op, impl) with counts: ``impl`` is ``"cuda"`` where the kernel
    launched and ``"plain"`` where a CPU tensor took the plain version.

A warm process is provably warm: re-running a solve after `reset()`, with
the libraries loaded, records zero build events.

The ledger never reads a clock (durations are stamped by the caller and
passed in), keeps bounded memory through an event cap, and is
process-global, as the loaded libraries it mirrors are.
"""

from __future__ import annotations

import contextlib
import dataclasses

# op events dedup per (op, impl) with counts, but build events are kept
# verbatim; past this bound recording stops and drops are counted
MAX_EVENTS = 4096


@dataclasses.dataclass(frozen=True)
class LedgerEvent:
    """One recorded build-path event."""

    kind: str  # "build" | "compile"
    name: str  # the source built (e.g. "cutvals")
    key: str  # the source hash of the build
    signature: str  # arg shape/dtype signature ("" for build events)
    duration_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CompileLedger:
    def __init__(self):
        self.events: list[LedgerEvent] = []
        self.dropped = 0
        # (op, impl) → dispatch count
        self.op_traces: dict[tuple[str, str], int] = {}

    # ------------------------------------------------------------- recording --
    def _append(self, event: LedgerEvent) -> None:
        if len(self.events) >= MAX_EVENTS:
            self.dropped += 1
            return
        self.events.append(event)

    def note_build(self, name: str, key: str, duration_s: float) -> None:
        self._append(LedgerEvent("build", name, key, "", float(duration_s)))

    def note_compile(
        self, name: str, key: str, signature: str, duration_s: float
    ) -> None:
        self._append(
            LedgerEvent("compile", name, key, signature, float(duration_s))
        )

    def note_op(self, op: str, impl: str) -> None:
        k = (op, impl)
        self.op_traces[k] = self.op_traces.get(k, 0) + 1

    def add_ops(self, ops: dict) -> None:
        """Count op dispatches made outside a wrapper's call (a CUDA graph's
        replay of what `set_aside_ops` took out of its capture)."""
        for k, n in ops.items():
            self.op_traces[k] = self.op_traces.get(k, 0) + n

    @contextlib.contextmanager
    def set_aside_ops(self):
        """Yields a dict that, when the block ends, holds the op dispatches
        noted inside it; those are taken back out of `op_traces`."""
        before = dict(self.op_traces)
        taken: dict[tuple[str, str], int] = {}
        try:
            yield taken
        finally:
            taken.update({k: n - before.get(k, 0) for k, n in self.op_traces.items()
                          if n != before.get(k, 0)})
            self.op_traces.clear()
            self.op_traces.update(before)

    # --------------------------------------------------------------- reading --
    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    @property
    def builds(self) -> list[LedgerEvent]:
        return [e for e in self.events if e.kind == "build"]

    @property
    def compiles(self) -> list[LedgerEvent]:
        return [e for e in self.events if e.kind == "compile"]

    def total_compile_s(self) -> float:
        return sum(e.duration_s for e in self.compiles)

    def snapshot(self) -> dict:
        """JSON-able view for metrics exports."""
        return {
            "builds": self.count("build"),
            "compiles": self.count("compile"),
            "compile_s": round(self.total_compile_s(), 6),
            "dropped": self.dropped,
            "op_traces": {
                f"{op}[{impl}]": n
                for (op, impl), n in sorted(self.op_traces.items())
            },
            "events": [e.as_dict() for e in self.events],
        }

    def reset(self) -> None:
        """Start a fresh accounting window. Unloads no library: a warm
        re-run after `reset()` must record zero build events."""
        self.events.clear()
        self.op_traces.clear()
        self.dropped = 0


# process-global, mirroring the process-global kernel libraries it audits
_LEDGER = CompileLedger()


def get_ledger() -> CompileLedger:
    return _LEDGER
