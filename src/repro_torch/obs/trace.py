"""Structured span tracer (port of ``repro/obs/trace.py``).

A `Span` is one named, timed interval with a parent pointer and a flat
attribute dict; a `Tracer` mints them against an injected clock (the
`repro_torch.obs.clock` contract: a counter clock makes a whole traced
solve deterministic). Two usage shapes:

  - **explicit-parent** ``begin(name, parent=...)`` / ``end(span)`` for
    spans that outlive a call frame;
  - **stack-scoped** ``with tracer.span(name):`` for synchronous stages
    (the solve's partition, solve_pool, merge and refine): the context
    manager keeps an implicit parent stack, and ``attach(span)`` pushes an
    existing span so nested library code parents its spans under it.

``record=False`` (the default) keeps no spans: `begin`/`end` still stamp
the clock, because the solve reads its stage timings from span durations,
but nothing is retained or exported. ``--trace-out`` on the CLI builds the
tracer with ``record=True``.

Work queued on the card runs after the host has moved on, so a host span
around it times the queueing. ``device_span`` also times the work: a
recording tracer on the default clock records a CUDA event on the current
stream at the span's start and end (never while that stream is captured
into a CUDA graph), and `resolve_device`, called once the caller has read
its results, places each pair on the tracer's clock through an anchor
event recorded once the device is idle, as the span's ``device_t0`` /
``device_t1`` attributes. An anchor taken before the work (`mark_device`)
lets it place them linearly between the two, which takes out the drift of
the card's timer against the host's clock. Everywhere else a device span
is a host span.

Retained spans export as JSON lines (one span object per line, sorted by
``(t0, span_id)``, so identical runs give byte-identical files) and in the
Chrome trace-event format (``ph: "X"`` complete events in microseconds),
which Perfetto loads; device intervals there are events of their own on
track (``tid``) 2.

The module-global accessors (`get_tracer` / `set_tracer` / `use_tracer`)
let the solve stages emit spans without a tracer argument: the default
global tracer records nothing, and a driver swaps its own in with
`use_tracer`.
"""

from __future__ import annotations

import contextlib
import json

from repro_torch.obs.clock import default_clock

# sentinel for `begin(parent=ROOT)`: force a parentless span even when
# the implicit stack is non-empty (e.g. a request submitted from inside
# another request's streaming callback must still root its own tree)
ROOT = object()


class Span:
    """One named, timed interval. ``t1 is None`` until ended."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, span_id, parent_id, name, t0, attrs):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        if self.t1 is None:
            raise ValueError(f"span {self.name!r} not ended")
        return self.t1 - self.t0

    @property
    def device_s(self) -> float:
        """Seconds of the span's work on the card where it has a device
        interval, else its host duration (work that runs where it is
        queued, as on the CPU)."""
        if "device_t1" in self.attrs:
            return self.attrs["device_t1"] - self.attrs["device_t0"]
        return self.duration_s

    def as_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:  # debugging aid, never parsed
        return (
            f"Span({self.name!r}, id={self.span_id}, "
            f"parent={self.parent_id}, t0={self.t0}, t1={self.t1})"
        )


class Tracer:
    """Mints spans against one injected clock; retains them only when
    ``record=True`` (tracing is off by default)."""

    def __init__(self, clock=default_clock, record: bool = False):
        self._clock = clock
        self.record = bool(record)
        self.spans: list[Span] = []  # ended spans, when recording
        self._stack: list[Span] = []  # implicit-parent stack
        self._next_id = 1
        # (span, CUDA device index, start event, end event) of the ended
        # device spans that `resolve_device` has not placed yet
        self._pending: list[tuple] = []
        self._marks: dict = {}  # CUDA device index → `mark_device`'s anchor

    # ------------------------------------------------------------ lifecycle --
    def begin(self, name: str, parent: Span | None = None, **attrs) -> Span:
        """Open a span. ``parent=None`` adopts the top of the implicit
        stack (or roots the span if the stack is empty); ``parent=ROOT``
        forces a parentless span regardless of the stack."""
        if parent is ROOT:
            parent = None
        elif parent is None and self._stack:
            parent = self._stack[-1]
        span = Span(
            self._next_id,
            None if parent is None else parent.span_id,
            name,
            self._clock(),
            attrs,
        )
        self._next_id += 1
        return span

    def end(self, span: Span, **attrs) -> Span:
        """Close a span (exactly once), merging any final attributes."""
        if span.t1 is not None:
            raise ValueError(f"span {span.name!r} ended twice")
        if attrs:
            span.attrs.update(attrs)
        span.t1 = self._clock()
        if self.record:
            self.spans.append(span)
        return span

    def span_at(
        self, name: str, t0: float, t1: float,
        parent: Span | None = None, **attrs,
    ) -> Span:
        """A retroactive complete span over caller-supplied stamps, for
        a window that cannot be opened live; the stamps must come from the
        same injected clock for the nesting invariants to hold."""
        if parent is ROOT:
            parent = None
        elif parent is None and self._stack:
            parent = self._stack[-1]
        span = Span(
            self._next_id,
            None if parent is None else parent.span_id,
            name,
            float(t0),
            attrs,
        )
        self._next_id += 1
        span.t1 = float(t1)
        if self.record:
            self.spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Span | None = None, **attrs):
        """Stack-scoped span: children begun inside the block nest
        under it implicitly."""
        s = self.begin(name, parent=parent, **attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            self.end(s)

    @contextlib.contextmanager
    def device_span(self, name: str, device, **attrs):
        """Stack-scoped span over work queued on ``device`` (a
        `torch.device`). Under a recording tracer on the default clock, on
        a CUDA device, it also records a CUDA event at its start and end
        (see the module docstring); otherwise it is `span`."""
        with self.span(name, **attrs) as s:
            index = _index(device) if self._times(device) else None
            start = None if index is None else _cuda_event(index)
            yield s
            end = None if start is None else _cuda_event(index)
            if end is not None:
                self._pending.append((s, index, start, end))

    def _times(self, device) -> bool:
        """Whether device spans on ``device`` get a device interval."""
        return (self.record and self._clock is default_clock
                and device.type == "cuda")

    def mark_device(self, device) -> None:
        """Anchor ``device``'s timer before the work whose device spans the
        next `resolve_device` places. It waits for the device: call it
        where nothing is queued there, as at the start of a solve."""
        if self._times(device):
            index = _index(device)
            self._marks[index] = _anchor(index, self._clock)

    def resolve_device(self) -> None:
        """Place the device intervals of the ended device spans on the
        tracer's clock. It waits for each device they ran on: call it once
        the caller has read its results, never between a launch and the
        read of its output."""
        pending, self._pending = self._pending, []
        marks, self._marks = self._marks, {}
        placed = {}
        for span, index, start, end in pending:
            if index not in placed:
                placed[index] = _placement(marks.get(index),
                                           _anchor(index, self._clock))
            span.attrs["device_t0"] = placed[index](start)
            span.attrs["device_t1"] = placed[index](end)

    @contextlib.contextmanager
    def attach(self, span: Span):
        """Push an *existing* (still-open) span onto the implicit stack
        without ending it — nested library spans parent under it."""
        self._stack.append(span)
        try:
            yield span
        finally:
            self._stack.pop()

    # --------------------------------------------------------------- export --
    def _sorted(self) -> list[Span]:
        return sorted(self.spans, key=lambda s: (s.t0, s.span_id))

    def to_jsonl(self) -> str:
        """One JSON object per line, byte-stable across identical runs."""
        return "\n".join(
            json.dumps(s.as_dict(), sort_keys=True) for s in self._sorted()
        )

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
            f.write("\n")
        return path

    def to_chrome(self) -> dict:
        """Chrome trace-event format: ``ph: "X"`` complete events in
        microseconds, loadable in Perfetto; the device intervals follow the
        host spans, on track 2."""
        events, device = [], []
        for s in self._sorted():
            args = dict(s.attrs)
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.t0 * 1e6,
                "dur": (s.t1 - s.t0) * 1e6,
                "pid": 1,
                "tid": 1,
                "args": args,
            })
            if "device_t1" in s.attrs:
                device.append({
                    "name": s.name,
                    "ph": "X",
                    "ts": s.attrs["device_t0"] * 1e6,
                    "dur": s.device_s * 1e6,
                    "pid": 1,
                    "tid": 2,
                    "args": {"span_id": s.span_id},
                })
        return {"traceEvents": events + device, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, sort_keys=True)
        return path

    def export(self, path: str, fmt: str = "jsonl") -> str:
        if fmt == "jsonl":
            return self.export_jsonl(path)
        if fmt == "chrome":
            return self.export_chrome(path)
        raise ValueError(f"unknown trace format {fmt!r}")


def _index(device) -> int:
    """A CUDA `torch.device`'s index: the current device's for "cuda"."""
    import torch

    return torch.cuda.current_device() if device.index is None else device.index


def _cuda_event(device):
    """A timing event recorded now on ``device``'s current stream, or None
    while the current stream is being captured into a CUDA graph (the
    capture would take the event in)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


ANCHOR_TRIES = 3  # anchors taken at a resolution; the tightest is kept


def _anchor(device, clock):
    """(event, time on ``clock``): an event recorded on ``device``'s
    current stream once the device is idle (so every event before it has
    run, on any stream), and the middle of the host's record of it and the
    first query that finds it done. A query, unlike a synchronize, returns
    within microseconds of the event; of `ANCHOR_TRIES` such anchors the
    one with the narrowest bracket is kept."""
    import torch

    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    brackets = []
    for _ in range(ANCHOR_TRIES):
        event = torch.cuda.Event(enable_timing=True)
        h0 = clock()
        event.record(stream)
        while not event.query():
            pass
        h1 = clock()
        brackets.append((h1 - h0, (h0 + h1) / 2, event))
    _, t, event = min(brackets, key=lambda b: b[0])
    return event, t


def _placement(mark, anchor):
    """The time on the tracer's clock of an event recorded before
    ``anchor``, an (event, time) pair, as a function: the anchor's time
    less the event's distance from it on the card's timer, scaled by the
    host's seconds a timer second between ``mark`` (an earlier pair, or
    None for 1) and the anchor."""
    event, t = anchor
    rate = 1.0
    if mark is not None:
        span_ms = mark[0].elapsed_time(event)
        if span_ms > 0:
            rate = (t - mark[1]) / (span_ms / 1e3)
    # elapsed_time(event) is the anchor's time less the event's, in ms
    return lambda e: t - e.elapsed_time(event) / 1e3 * rate


# ------------------------------------------------------- global accessors --
# the ambient tracer the solve stages emit against; records nothing until
# a driver installs its own (tracing off by default)
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scope-bound global-tracer override (restores on exit, even on
    error): the spans of the solve stages inside land in ``tracer``."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
