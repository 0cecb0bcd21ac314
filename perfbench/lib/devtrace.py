"""The device trace of a window: ``torch.profiler`` over the card's
activity, tied to the host's clock by an anchor kernel, and read into the
operations that ran, the time the device was busy, and the idle gaps with
the solver's span that was open on the host meanwhile.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

ANCHOR = "spin_kernel"  # the kernel of torch.cuda._sleep


@dataclasses.dataclass
class Reading:
    ops: list  # (name, start_ns, duration_ns) of each device operation, host ns
    busy_s: float  # time in [t0, t1] with an operation running
    window_s: float
    gaps: list  # (seconds, label) of each idle gap, longest first


def kernel_name(name: str) -> str:
    """A device operation's name without its return type, namespace and
    arguments: ``void (anonymous namespace)::fused_kernel<true>(float
    const*, ...)`` is ``fused_kernel<true>``."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # cut at the first '(' outside a template argument
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out).strip()


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._anchor_ns = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._anchor_ns = time.perf_counter_ns()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()

    def stop(self):
        torch.cuda.synchronize()
        self._prof.stop()

    def read(self, t0: float, t1: float, spans) -> Reading:
        """The operations in the window [t0, t1] (host seconds of
        ``time.perf_counter``), and its gaps labelled by ``spans``, the
        solver's recorded spans."""
        from torch.autograd import DeviceType

        events = [e for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        anchors = [e for e in events if ANCHOR in e.name()]
        if not anchors:
            raise RuntimeError("the device trace holds no anchor kernel")
        offset = min(e.start_ns() for e in anchors) - self._anchor_ns
        ops = sorted((kernel_name(e.name()), e.start_ns() - offset, e.duration_ns())
                     for e in events if ANCHOR not in e.name())
        ops = [(n, s, d) for n, s, d in ops if s + d > t0 * 1e9 and s < t1 * 1e9]
        lo, hi = int(t0 * 1e9), int(t1 * 1e9)
        busy, gaps, cursor = 0, [], lo
        for _, s, d in sorted(ops, key=lambda o: o[1]):
            a, b = max(s, lo), min(s + d, hi)
            if a > cursor:
                gaps.append((cursor, a))
            if b > cursor:
                busy += b - max(a, cursor)
                cursor = b
        if hi > cursor:
            gaps.append((cursor, hi))
        label = _Labels(spans)
        labelled = sorted(((b - a) / 1e9, label((a + b) / 2e9)) for a, b in gaps)
        return Reading(ops=ops, busy_s=busy / 1e9, window_s=t1 - t0,
                       gaps=labelled[::-1])


class _Labels:
    """The innermost recorded span open at a host time. The solver's spans
    nest two deep (a solve, then its stages one after another), so the
    stages and the solves are each disjoint and sorted."""

    def __init__(self, spans):
        self.levels = []
        for inner in (True, False):
            level = sorted((s.t0, s.t1, s.name) for s in spans
                           if (s.parent_id is not None) == inner)
            self.levels.append(([a for a, _, _ in level], level))

    def __call__(self, t: float) -> str:
        for starts, level in self.levels:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and level[i][1] >= t:
                return level[i][2]
        return "between solves"
