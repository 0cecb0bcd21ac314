"""Block-shape tuning for the CUDA kernels (port of ``repro/kernels/tuning.py``).

Every kernel wrapper resolves its launch geometry through
``param(op, dim, name, default, device)`` just before it launches. With
tuning disabled (the default) the lookup returns ``default``, the
kernel's built-in geometry, so launches and their numerics are exactly
those of the untuned kernels. With tuning enabled, lookups consult a
table keyed per ``(op, shape bucket, backend)``:

  - the committed table (``tuning_cache.json`` beside this module, written
    by ``python -m repro_torch.benchmarks.kernel_autotune --write-cache``
    from a run on the H100), or
  - an explicit override table (`using_overrides`, used by the sweep).

The backend part of a key is the device type of the tensors the kernel
runs on (``cuda`` or ``cpu``). PyTorch runs eagerly, so there is no
traced program to key: a change of tuning state takes effect at the next
launch. `state` and `using_state` keep the reference's API for code that
captures the state and restores it later.

This module is also the sweep's measurement path: `measure` times calls
through the injectable `repro_torch.obs.clock.default_clock`, and on the
card synchronizes the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.obs.clock import default_clock

CACHE_PATH = os.path.join(os.path.dirname(__file__), "tuning_cache.json")

# Ops with tunable launch geometry and the names of their knobs; the sweep
# and the cache validator both enumerate from here. The op names are the
# reference's; the knobs are the CUDA kernels' own (the strided mixer
# block owns one (b, x) slab, so it has no ``tile_x``).
TUNABLE_OPS = {
    "apply_phase": ("tile",),
    "expectation": ("tile",),
    "mixer_matmul": ("row_tile",),
    "mixer_strided": ("tile_y",),
    "fused_layer": ("row_tile",),
    "cutvals": ("tile_b",),
    "cutvals_at": ("tile_b",),
    "cut_batch_dense": ("batch_tile", "k_chunk"),
}


# ---------------------------------------------------------------------------
# tile / padding arithmetic
# ---------------------------------------------------------------------------

def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of `multiple` that is >= x."""
    return ((x + multiple - 1) // multiple) * multiple


def clamp_tile(dim: int, tile: int) -> int:
    """Clamp a tile to the dimension it blocks; the dim must tile evenly
    (the statevector dims are powers of two, as are the tiles)."""
    t = min(tile, dim)
    if dim % t:
        raise ValueError(f"tile {tile} does not divide dimension {dim}")
    return t


def pad_chunks(count: int, chunk: int) -> int:
    """Pad a count up to a chunk multiple, with at least one full chunk."""
    return max(chunk, round_up(count, chunk))


def pad_and_tile(count: int, tile: int) -> Tuple[int, int]:
    """(padded_count, tile) for a dimension that may not divide the tile:
    clamp the tile to the count, then pad the count to a tile multiple."""
    t = min(tile, count)
    return round_up(count, t), t


def is_pow2(x: int) -> bool:
    return x >= 1 and not x & (x - 1)


# ---------------------------------------------------------------------------
# (op, shape bucket, backend) table
# ---------------------------------------------------------------------------

def shape_bucket(dim: int) -> str:
    """Power-of-two shape bucket: the smallest 2^b >= dim, as '2^b'."""
    if dim < 1:
        raise ValueError(f"dimension {dim} < 1")
    return f"2^{(dim - 1).bit_length()}"


def backend_of(device) -> str:
    """The backend part of a key: the device type, ``cuda`` or ``cpu``."""
    return torch.device(device).type


def cache_key(op: str, dim: int, backend: str = "cuda") -> str:
    return f"{op}|{shape_bucket(dim)}|{backend}"


_ENABLED = False
_OVERRIDES: Optional[Dict[str, Dict[str, int]]] = None  # None → committed table
_COMMITTED: Optional[Dict[str, Dict[str, int]]] = None  # loaded at first use


def _committed() -> Dict[str, Dict[str, int]]:
    global _COMMITTED
    if _COMMITTED is None:
        try:
            with open(CACHE_PATH) as f:
                _COMMITTED = dict(json.load(f).get("entries", {}))
        except (OSError, ValueError):
            _COMMITTED = {}
    return _COMMITTED


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def active_config() -> Dict[str, Dict[str, int]]:
    return _OVERRIDES if _OVERRIDES is not None else _committed()


def param(op: str, dim: int, name: str, default: int, device="cuda") -> int:
    """Resolve one knob of ``op`` for a launch on ``device``."""
    if not _ENABLED:
        return default
    entry = active_config().get(cache_key(op, dim, backend_of(device)))
    if not entry:
        return default
    return int(entry.get(name, default))


def state() -> tuple:
    """The active tuning state as a hashable value: ``("off",)`` when
    disabled, else the flattened table; `using_state` restores it."""
    if not _ENABLED:
        return ("off",)
    cfg = active_config()
    return (
        "on",
        tuple((key, tuple(sorted(entry.items())))
              for key, entry in sorted(cfg.items())),
    )


@contextlib.contextmanager
def using_state(st: tuple):
    """Re-assert a tuning state captured by `state()` inside the block."""
    global _ENABLED, _OVERRIDES
    prev = (_ENABLED, _OVERRIDES)
    if st == ("off",):
        _ENABLED, _OVERRIDES = False, None
    else:
        if not st or st[0] != "on":
            raise ValueError(f"not a tuning state: {st!r}")
        _ENABLED = True
        _OVERRIDES = {key: dict(items) for key, items in st[1]}
    try:
        yield
    finally:
        _ENABLED, _OVERRIDES = prev


@contextlib.contextmanager
def using_overrides(cfg: Dict[str, Dict[str, int]]):
    """Enable tuning with an explicit table inside the block (the sweep)."""
    global _ENABLED, _OVERRIDES
    prev = (_ENABLED, _OVERRIDES)
    _ENABLED, _OVERRIDES = True, dict(cfg)
    try:
        yield
    finally:
        _ENABLED, _OVERRIDES = prev


def invalidate_committed() -> None:
    """Drop the loaded committed table (after ``--write-cache``)."""
    global _COMMITTED
    _COMMITTED = None


# ---------------------------------------------------------------------------
# measurement: the sweep's only timing boundary
# ---------------------------------------------------------------------------

def _sync(result) -> None:
    """Wait for the device that holds the first CUDA tensor of ``result``."""
    items = result if isinstance(result, (tuple, list)) else (result,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def measure(fn: Callable, *args, repeats: int = 3,
            clock: Callable[[], float] = default_clock):
    """(result, best_seconds) over ``repeats`` timed calls after one warmup.

    Each timed call ends by synchronizing the device its result lies on
    before the clock is read, so the device's work is inside the window.
    The clock is injectable (the tests pass a virtual one).
    """
    result = fn(*args)
    _sync(result)
    best = None
    for _ in range(max(1, repeats)):
        t0 = clock()
        result = fn(*args)
        _sync(result)
        dt = clock() - t0
        best = dt if best is None else min(best, dt)
    return result, best
