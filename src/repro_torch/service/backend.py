"""Pluggable solver backends for the solve service (port of
``repro/service/backend.py``).

The scheduler's packing is backend-agnostic: it builds fixed-shape
``batch_slots``-row buckets and hands them to a backend's `solve_batch`.

  - `LocalBackend` runs `qaoa.solve_subgraph_batch` on one device.
  - `MeshBackend` routes the *same* padded batch through
    `core.distributed.solve_pool` over the batch axes (`data`, `pod`) of
    a `core.axis.Mesh`: `LocalAxis` row blocks on one card, process
    groups under a launcher. A row's bits do not depend on the batch it
    is solved in, so every request's cut is the same through either
    backend, and the same as a solo `solve()`.

Backends return results whose tensors are not computed yet: nothing on
the solve path reads the card back, so `solve_batch` returns once its
launches are queued, and the scheduler keeps admitting and dispatching
while earlier batches run. It blocks only when it harvests (``.cpu()``)
the oldest batch in flight.
"""

from __future__ import annotations

import math

from repro_torch.core import qaoa as qaoa_mod
from repro_torch.device import resolve_device


class LocalBackend:
    """Single-device batched solver: one `solve_subgraph_batch` a batch."""

    name = "local"

    def __init__(self, device="cuda"):
        resolve_device(device)  # raises where a requested GPU is missing

    def solve_batch(self, qcfg: qaoa_mod.QAOAConfig, edges, weights, masks,
                    linears=None):
        return qaoa_mod.solve_subgraph_batch(edges, weights, masks, qcfg,
                                             linear=linears)

    def describe(self) -> dict:
        return {"backend": self.name, "devices": 1}


class MeshBackend:
    """Batches routed through `solve_pool` over a mesh's batch axes.

    ``mesh_spec`` is anything `core.distributed.as_mesh` resolves: a
    `Mesh`, a parsed ``{"data": 4}`` dict, or a ``"data=4"`` string. In
    one process every shard is a row block of one batch on ``device``;
    under a launcher each rank solves its block. The mesh must have a
    `data` or `pod` axis.
    """

    name = "mesh"

    def __init__(self, mesh_spec, device="cuda"):
        from repro_torch.core import distributed as dist

        self._dist = dist
        self.device = resolve_device(device)
        self.mesh = dist.as_mesh(mesh_spec, self.device)
        if self.mesh is None or not self.mesh.shape:
            raise ValueError(f"MeshBackend needs a non-empty mesh: {mesh_spec!r}")
        self.axes = self.mesh.data_axes
        if not self.axes:
            raise ValueError(f"mesh {self.mesh.shape} has no data/pod axis to "
                             "shard the solver pool over")

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def solve_batch(self, qcfg: qaoa_mod.QAOAConfig, edges, weights, masks,
                    linears=None):
        return self._dist.solve_pool(edges, weights, masks, qcfg, self.mesh,
                                     axes=self.axes, linears=linears)

    def describe(self) -> dict:
        return {
            "backend": self.name,
            "mesh": dict(self.mesh.shape),
            "axes": list(self.axes),
            "devices": self.n_devices,
        }


def make_backend(mesh_spec=None, device="cuda"):
    """``ServiceConfig.mesh`` → backend on ``device`` (default the GPU;
    raises when it is missing): None keeps the single-device solver."""
    if mesh_spec is None:
        return LocalBackend(device)
    return MeshBackend(mesh_spec, device)
