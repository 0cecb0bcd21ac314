"""Fault-tolerance substrate (port of the JAX package's
``training/fault_tolerance.py``).

  1. checkpoint/restart  — CheckpointManager (atomic rename + async writer)
     plus `resume_or_init`: the standard "crash anywhere, rerun the same
     command" loop contract. The data pipeline is a pure function of step,
     so a restart replays no data and skips none.

  2. re-placement        — `reshard_state`: put host (or another device's)
     state on one device. Checkpoints are stored unsharded, so this is a
     copy; placements sharded over a mesh come with the sharding slice.

  3. straggler detection — `HeartbeatMonitor` flags stalled steps and can
     trigger checkpoint-and-restart rather than waiting.

  4. gradient compression — int8 + error feedback (training/train_step.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import Mapping
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWState


def resume_or_init(ckpt: Optional[CheckpointManager], init_fn: Callable[[], object]):
    """Standard restart contract: latest checkpoint if present, else init."""
    if ckpt is not None and ckpt.latest_step() is not None:
        template = init_fn()
        step, state, _ = ckpt.restore(template)
        return step, state, True
    return 0, init_fn(), False


def reshard_state(state, device):
    """Place a state (its modules, mappings, named tuples and tensors) on
    ``device``, its structure kept: a module moves in place (``Module.to``),
    a tensor elsewhere is copied there. The optimizer's step counter stays
    on the host."""
    device = torch.device(device)

    def place(x):
        if isinstance(x, nn.Module):
            return x.to(device)
        if isinstance(x, Mapping):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, AdamWState):
            return AdamWState(step=x.step, mu=place(x.mu), nu=place(x.nu))
        if hasattr(x, "_fields"):
            return type(x)(*(place(v) for v in x))
        return None if x is None else x.to(device)

    return place(state)


@dataclasses.dataclass
class HeartbeatMonitor:
    """Detects stalled training steps (straggling/hung host).

    The train loop calls beat(step) after every step; a watcher thread
    flags (and optionally calls on_stall) if no beat arrives within
    `timeout_s`. In a real deployment on_stall checkpoints and exits
    non-zero so the scheduler restarts the job on healthy nodes.
    """

    timeout_s: float = 300.0
    on_stall: Optional[Callable[[int], None]] = None

    def __post_init__(self):
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self, step: int):
        self._last_beat = time.monotonic()
        self._last_step = step

    @property
    def stalled(self) -> bool:
        return self._stalled

    def stop(self):
        self._stop.set()

    def _watch(self):
        while not self._stop.wait(min(self.timeout_s / 10, 1.0)):
            if time.monotonic() - self._last_beat > self.timeout_s:
                self._stalled = True
                if self.on_stall:
                    self.on_stall(self._last_step)
                return
