"""Stack-scoped span tracer: the part of ``repro/obs/trace.py`` the solve uses.

A `Span` is one named, timed interval with a parent pointer and a flat
attribute dict; a `Tracer` mints them against an injected clock. The solve
stamps its stages with ``with get_tracer().span(name):`` and reads each
stage's `Span.duration_s` into its timings. Spans are stamped, not kept:
exporting a trace is not ported yet.
"""

from __future__ import annotations

import contextlib

from repro_torch.obs.clock import default_clock


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


class Tracer:
    """Mints spans against one clock."""

    def __init__(self, clock=default_clock):
        self._clock = clock
        self._stack: list[Span] = []  # implicit-parent stack
        self._next_id = 1

    def begin(self, name: str, **attrs) -> Span:
        parent = self._stack[-1] if self._stack else None
        span = Span(self._next_id, None if parent is None else parent.span_id,
                    name, self._clock(), attrs)
        self._next_id += 1
        return span

    def end(self, span: Span) -> Span:
        if span.t1 is not None:
            raise ValueError(f"span {span.name!r} ended twice")
        span.t1 = self._clock()
        return span

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Stack-scoped span: spans begun inside the block nest under it."""
        s = self.begin(name, **attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            self.end(s)


# the ambient tracer the solve stages stamp against
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL
