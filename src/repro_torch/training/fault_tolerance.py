"""Fault-tolerance substrate (port of the JAX package's
``training/fault_tolerance.py``).

  1. checkpoint/restart  — CheckpointManager (atomic rename + async writer)
     plus `resume_or_init`: the standard "crash anywhere, rerun the same
     command" loop contract. The data pipeline is a pure function of step,
     so a restart replays no data and skips none.

  2. re-placement        — `reshard_state`: put a state on one device, or
     shard it over a ``DeviceMesh`` as `launch.sharding.params_shardings`
     says (from one device, or from a sharding on another mesh: the
     elastic re-mesh). Checkpoints are stored unsharded.

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

from repro_torch.models.layers import is_dtensor
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWState


def resume_or_init(ckpt: Optional[CheckpointManager], init_fn: Callable[[], object]):
    """Standard restart contract: latest checkpoint if present, else init."""
    if ckpt is not None and ckpt.latest_step() is not None:
        template = init_fn()
        step, state, _ = ckpt.restore(template)
        return step, state, True
    return 0, init_fn(), False


def _to_device(x, device):
    """A tensor on ``device``; a DTensor is gathered whole first."""
    if is_dtensor(x):
        x = x.full_tensor()
    return x.to(device)


def _to_sharding(x, sharding):
    """A tensor placed as ``sharding`` (a `launch.sharding.Sharding`): a
    DTensor on the same mesh is redistributed, one on another mesh is
    gathered whole and placed afresh, a plain tensor is distributed."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        if x.device_mesh == sharding.mesh:
            return x.redistribute(sharding.mesh, sharding.placements)
        x = x.full_tensor()
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def reshard_state(state, target):
    """Place a state (its modules, mappings, named tuples and tensors),
    its structure kept, on ``target``: a device, or a sharding,
    ``{parameter name: Sharding}`` as `launch.sharding.params_shardings`
    returns it. A module is changed in place (each parameter replaced);
    a mapping's tensors (an `AdamWState`'s moments: by parameter name) and
    a named tuple's (a `DecodeState`'s: by field) are looked up by their
    keys; other tensors go to the target device, or, under a sharding,
    stay where they are. The optimizer's
    step counter stays on the host. A sharded state comes back to one
    device whole (``full_tensor``)."""
    if isinstance(target, Mapping):
        def put(name, x):
            return x if name not in target else _to_sharding(x, target[name])
    else:
        device = torch.device(target)

        def put(name, x):
            return _to_device(x, device)

    def place(x, name=None):
        if isinstance(x, nn.Module):
            for full, p in list(x.named_parameters()):
                mod_name, _, leaf = full.rpartition(".")
                mod = x.get_submodule(mod_name)
                with torch.no_grad():
                    mod._parameters[leaf] = nn.Parameter(
                        put(full, p.detach()), requires_grad=p.requires_grad)
            return x
        if isinstance(x, AdamWState):
            return AdamWState(step=x.step, mu=place(x.mu), nu=place(x.nu))
        if isinstance(x, Mapping):
            return {k: place(v, k) for k, v in x.items()}
        if hasattr(x, "_fields"):
            return type(x)(*(place(v, f) for f, v in zip(x._fields, x)))
        if not isinstance(x, torch.Tensor):
            return x  # None, a host count
        return put(name, x)

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
