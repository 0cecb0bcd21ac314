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

On the card the local backend dispatches a bucket as one CUDA graph, the
counterpart of the reference's one compiled program a bucket: the part of
`qaoa.solve_subgraph_batch` that needs nothing from the host
(`qaoa.solve_batch_on_device`: the cost diagonal, every Adam step with its
backward, the final evolution and ⟨cut⟩; 2,724 kernels at N = 12, T = 30)
is captured once per bucket (`_graph_key`) and replayed. The key also
holds the dispatch state a capture bakes in, the block-shape tuning state
(`tuning.state()`), read at the call, and the capture runs under exactly
that state, so a graph is never replayed under another one (the
reference keys its compiled programs on it too). A dispatch is
then a copy of its inputs into the graph's, one graph launch and copies
of the outputs, all on the current stream, so it never waits behind a stall of
the card for room in the launch queue, and stream order makes one graph
enough with several dispatches in flight. A capture synchronises the
card, so the service captures every bucket its planner's grid can reach
when it is built (`LocalBackend.prepare`), and no dispatch of its
captures; a direct `solve_batch` on a bucket not prepared captures it
first. `qaoa.topk_marginal` stays outside the graph: it copies host row
indices up. A capture that fails raises; nothing falls back to eager
dispatch. The mesh backend and the solo `solve()` dispatch eagerly.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from repro_torch.core import qaoa as qaoa_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, tuning
from repro_torch.obs.ledger import get_ledger

# eager runs of a bucket on a side stream before its capture, as
# `torch.cuda.graph` asks: they set each kernel's attributes and build the
# autograd engine's state; their launches are real and counted
GRAPH_WARMUP = 2


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # static edges, weights, linear (or None)
    outputs: tuple  # static gammas, betas, re, im, expectation
    launches: collections.Counter  # kernel launches a replay makes
    ops: dict  # (op, impl) → ledger op notes a replay stands for


# process-global, as the kernel libraries are: one graph per bucket key
_GRAPHS: dict = {}


def _graph_key(qcfg: qaoa_mod.QAOAConfig, device, rows: int, e_pad: int,
               linear: bool, tune: tuple) -> tuple:
    """What fixes a bucket's graph: the device, rows, padded edges, linear
    terms or none, every knob of the device part (not ``top_k``), and the
    tuning state that sets each launch's geometry, which the caller reads:
    ``tune`` = `tuning.state()`."""
    return (str(device), rows, e_pad, linear, qcfg.n_qubits,
            qcfg.p_layers, qcfg.opt_steps, qcfg.learning_rate, qcfg.ramp_delta,
            qcfg.mixer_group, tune)


def graph_count() -> int:
    """How many buckets have a captured graph."""
    return len(_GRAPHS)


def clear_graphs() -> None:
    """Drop every captured graph and its memory pool."""
    _GRAPHS.clear()


def _capture(qcfg, edges, weights, linears, tune: tuple) -> _Graph:
    """Warm up on a side stream, then capture `qaoa.solve_batch_on_device`
    on static copies of the inputs, all under the keyed tuning state
    ``tune``, so that the graph records no geometry its key does not
    name. The launches and ledger notes made while capturing ran nothing:
    they are set aside for each replay to add."""
    dev = edges.device
    inputs = tuple(None if t is None else t.clone() for t in (edges, weights, linears))
    with tuning.using_state(tune):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                qaoa_mod.solve_batch_on_device(*inputs[:2], qcfg, inputs[2])
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with ops.set_aside_launches() as launched, get_ledger().set_aside_ops() as noted:
            with torch.cuda.graph(graph):
                outputs = qaoa_mod.solve_batch_on_device(*inputs[:2], qcfg, inputs[2])
    return _Graph(graph, inputs, outputs, launched, noted)


def solve_graphed(qcfg: qaoa_mod.QAOAConfig, edges, weights, masks,
                  linears=None) -> qaoa_mod.QAOAResult:
    """`qaoa.solve_subgraph_batch` on the card through the bucket's CUDA
    graph (captured first where it is not yet): the same kernels in the
    same order, so the same bits. ``masks`` on the host, as there."""
    tune = tuning.state()
    key = _graph_key(qcfg, edges.device, *edges.shape[:2], linears is not None,
                     tune)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _capture(qcfg, edges, weights, linears, tune)
    for static, t in zip(g.inputs, (edges, weights, linears)):
        if static is not None:
            static.copy_(t)
    g.graph.replay()
    ops.add_launches(g.launches)
    get_ledger().add_ops(g.ops)
    gammas, betas, re, im, exp = g.outputs
    with torch.no_grad():
        bits, probs = qaoa_mod.topk_marginal(re, im, qcfg.n_qubits, masks, qcfg.top_k)
    return qaoa_mod.QAOAResult(bits, probs, exp.clone(), gammas.clone(), betas.clone())


class LocalBackend:
    """Single-device batched solver: one `solve_subgraph_batch` a batch,
    as one CUDA graph a bucket on the card (`solve_graphed`)."""

    name = "local"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)  # raises where a requested GPU is missing

    def prepare(self, buckets, rows: int) -> int:
        """Capture the graph of each bucket of ``buckets``, (`QAOAConfig`,
        padded edges a row, linear terms or not), at ``rows`` rows, where it
        is not yet captured: the service does it when it is built, so that
        no dispatch captures. Returns how many were captured; on the CPU,
        where nothing is graphed, 0."""
        if self.device.type != "cuda":
            return 0
        made = 0
        tune = tuning.state()
        for qcfg, e_pad, linear in buckets:
            edges = torch.zeros((rows, e_pad, 2), dtype=torch.int32, device=self.device)
            key = _graph_key(qcfg, edges.device, rows, e_pad, linear, tune)
            if key in _GRAPHS:
                continue
            weights = torch.zeros((rows, e_pad), dtype=torch.float32, device=self.device)
            lin = (torch.zeros((rows, qcfg.n_qubits), dtype=torch.float32,
                               device=self.device) if linear else None)
            _GRAPHS[key] = _capture(qcfg, edges, weights, lin, tune)
            made += 1
        return made

    def solve_batch(self, qcfg: qaoa_mod.QAOAConfig, edges, weights, masks,
                    linears=None):
        if edges.device.type == "cuda":
            return solve_graphed(qcfg, edges, weights, masks, linears)
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
