"""The port's single time source for spans (copy of ``repro/obs/clock.py``).

Every span stamp flows from a clock callable injected into the `Tracer`,
defaulting to ``default_clock``: monotonic, high resolution, never used
for decisions.
"""

from __future__ import annotations

import time

default_clock = time.perf_counter
