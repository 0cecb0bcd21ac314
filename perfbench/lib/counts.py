"""The counts of ``perfbench/counts/``: every file there that names a
kernel (``OP``, the solver's launch counter, and ``KERNELS``, its device
kernels) gives the operations and bytes of one launch at a cell's shapes.
A new file is found by the directory listing alone."""

from __future__ import annotations

import importlib
from pathlib import Path

from perfbench.lib import peaks

HERE = Path(__file__).resolve().parents[1] / "counts"


def kernel_counts() -> dict:
    """{module name: module} of every kernel count."""
    out = {}
    for path in sorted(HERE.glob("*.py")):
        mod = importlib.import_module(f"perfbench.counts.{path.stem}")
        if hasattr(mod, "OP"):
            out[path.stem] = mod
    return out


def least_s_of(mod, *shape) -> float:
    return peaks.least_s(*mod.work(*shape))


def owner(kernel: str, counts: dict):
    """The count whose device kernels include ``kernel`` (a name as
    `devtrace.kernel_name` gives it), or None."""
    for mod in counts.values():
        for k in mod.KERNELS:
            if kernel == k or kernel.startswith(k + "<"):
                return mod
    return None
