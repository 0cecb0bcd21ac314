"""Per-layer metric readers, one file per metric of BENCHMARK.json,
each with ``read(window, log)`` returning the value or None."""
