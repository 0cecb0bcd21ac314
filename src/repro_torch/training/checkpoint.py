"""Checkpoint manager: atomic, async, restart-safe (port of the JAX
package's ``training/checkpoint.py``, with its on-disk layout).

  - atomic: write to <dir>/.tmp-<step>, fsync, rename — a crash mid-write
    never corrupts the latest checkpoint;
  - async: the device→host copy happens in ``save`` (a copy even on the CPU:
    a step updates the parameters in place, so a view would hold the next
    step's values by the time the writer reads it), serialization on a
    writer thread so the train loop isn't blocked;
  - restart: `latest_step` + `restore` resume exactly (params, optimizer
    moments, data-pipeline step — the data pipeline is a pure function of
    step, so no loader state is needed);
  - retention: keep the last `keep` checkpoints.

A checkpoint is one ``arrays.npz`` of ``/``-joined names and ``meta.json``.
The port writes its own names (``params/blocks/3/attn/wq``, one array a
layer). `read` returns any checkpoint, the reference's stacked ones
included, as named numpy arrays; `nest` gives them the nested form that
``convert.train_state_from_arrays`` turns into the port's state.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = ""):
    """(``a/b/c``, tensor) of every tensor of a state: modules by parameter
    name, mappings by key (dots become slashes), named tuples by field;
    None is skipped."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{str(k).replace('.', '/')}/")
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{prefix}{k}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _flatten(state) -> dict:
    """{name: numpy copy} of a state's tensors."""
    return {name: t.detach().to("cpu", copy=True).numpy() for name, t in _leaves(state)}


def _load_into(template, flat: Mapping) -> None:
    """Copy ``flat``'s arrays into the tensors of ``template`` in place."""
    own = dict(_leaves(template))
    missing, extra = sorted(own.keys() - flat.keys()), sorted(flat.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"checkpoint arrays missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, t in own.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {arr.shape}, the state's {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.asarray(arr)))


def nest(flat: Mapping) -> dict:
    """{"a/b": x} → {"a": {"b": x}}."""
    out: dict = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_write
        self._error: Optional[BaseException] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ api
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Snapshot state (device→host copy now, disk write maybe async)."""
        payload = (step, _flatten(state), extra or {})
        if self._async:
            self._q.put(payload)
        else:
            self._write(*payload)

    def wait(self):
        """Block until pending async writes land (call before exit)."""
        if self._async:
            self._q.join()
        if self._error:
            raise self._error

    def latest_step(self) -> Optional[int]:
        steps = [
            int(d.split("-")[1])
            for d in os.listdir(self.dir)
            if d.startswith("step-") and not d.startswith(".")
        ]
        return max(steps) if steps else None

    def read(self, step: Optional[int] = None):
        """(step, {"a/b/c": numpy array}, meta) of a checkpoint, the latest
        by default."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step-{step}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}
        with open(os.path.join(path, "meta.json")) as f:
            extra = json.load(f)
        return step, flat, extra

    def restore(self, template: Any, step: Optional[int] = None):
        """Load a checkpoint into ``template``'s tensors (in place, on their
        devices); returns (step, template, meta)."""
        step, flat, extra = self.read(step)
        _load_into(template, flat)
        return step, template, extra

    # ------------------------------------------------------------- internals
    def _worker(self):
        while True:
            payload = self._q.get()
            try:
                self._write(*payload)
            except BaseException as e:  # surfaced on wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **extra}, f)
        with open(os.path.join(tmp, "arrays.npz"), "rb") as f:
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(d.split("-")[1])
            for d in os.listdir(self.dir)
            if d.startswith("step-")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"), ignore_errors=True)
