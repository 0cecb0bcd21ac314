"""The mesh axes of a solve, as objects.

``repro/core/engine.py`` runs the sharded statevector under ``shard_map``:
each device holds one shard of 2^(n-h) amplitudes and names the axis in
``all_to_all``, ``psum`` and ``all_gather``. The port keeps the same
per-shard algebra and makes the axis an object with two implementations
behind one interface:

- `LocalAxis(D)`: all D shards in one process, as rows of the leading
  axis, row = (subgraph, shard). The kernels take (rows, L) planes with one
  angle per row, so one launch covers every shard. This is how one card
  hosts a mesh axis, as XLA's host-device emulation does for JAX.
- `ProcessGroupAxis`: one shard per rank over ``torch.distributed`` (NCCL
  between GPUs, gloo on the CPU).

Both hold ``local`` shards per subgraph in this process, shards
``offset .. offset + local - 1`` of ``size``; a tensor on the axis has
``B * local`` rows, subgraph-major.

A `Mesh` holds one axis per role of the JAX mesh, ``pod``, ``data`` and
``model`` (``repro/launch/mesh.py`` ``AXIS_ORDER``, outermost first):
the `model` axis shards a statevector (its size a power of two, h =
log2 D qubits on the axis); ``pod`` and ``data`` are batch axes, over
which the solver pool splits its rows and the merge stripes its frontier
(the innermost of them). In one process every axis is a `LocalAxis`;
under a launcher each rank sits at its row-major position of the mesh,
as the JAX mesh orders its devices, and each role gets the process
group of the ranks that differ only in that role's coordinate.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AXIS_ORDER, mesh_spec_size


class _Swap(torch.autograd.Function):
    """The qubit-swap all_to_all. It is its own inverse, so its backward
    is the same swap of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis, chunk):
        ctx.axis, ctx.chunk = axis, chunk
        return axis._exchange(x, chunk)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._exchange(g.contiguous(), ctx.chunk), None, None


class _Axis:
    size: int  # D: shards of the axis
    local: int  # shards of each subgraph held by this process
    offset: int  # shard index of the first of them

    @property
    def h(self) -> int:
        """log2(D): the qubits that live on the axis ("global" qubits); only
        a `model` axis has them, so only its size must be a power of two."""
        if self.size & (self.size - 1):
            raise ValueError(f"axis size {self.size} must be a power of two "
                             "to shard a statevector")
        return self.size.bit_length() - 1

    def shard_ids(self, device=None) -> torch.Tensor:
        """(local,) int64: the indices of the shards this process holds."""
        return torch.arange(self.offset, self.offset + self.local,
                            device=device)

    def swap(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        """Layout A <-> layout B of (B·local, D·chunk) planes: shard p's
        block d goes to shard d's block p (``engine.py:171-178``)."""
        return _Swap.apply(x, self, chunk)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(B·local, ...) per-shard values → (B, ...) sums over the axis
        (the ``psum``), the same on every process."""
        return self.reduce(x.reshape(-1, self.local, *x.shape[1:]).sum(1))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """(local, ...) per-shard values → their max over every shard of
        the axis (the ``pmax``), the same on every process."""
        return self.reduce(x.amax(0), "max")

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """(local, ...) per-shard values → their min over every shard (the
        ``pmin``), the same on every process."""
        return self.reduce(x.amin(0), "min")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B·local, k) → (B, D·k): every shard's row, in shard order (the
        ``all_gather``), the same on every process."""
        raise NotImplementedError

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(local·b, ...) rows, shard-major → (D·b, ...): every shard's
        block of rows in shard order, the same on every process."""
        raise NotImplementedError

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ("sum", "max" or "min") of a tensor over the processes of
        the axis."""
        raise NotImplementedError

    def _exchange(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        raise NotImplementedError


class LocalAxis(_Axis):
    """Every shard of the axis in this process, as rows (subgraph, shard)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"axis size {size} must be >= 1")
        self.size = self.local = size
        self.offset = 0

    def __repr__(self):
        return f"LocalAxis({self.size})"

    def _exchange(self, x, chunk):
        d = self.size
        # a transpose of each subgraph's (D, D, chunk) block grid, copied:
        # the kernels take contiguous planes
        return (x.view(-1, d, d, chunk).transpose(1, 2).contiguous()
                .view(x.shape))

    def gather(self, x):
        return x.reshape(-1, self.size * x.shape[-1])

    def gather_rows(self, x):
        return x

    def reduce(self, t, op="sum"):
        return t


class ProcessGroupAxis(_Axis):
    """One shard per rank of a ``torch.distributed`` process group."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.local = 1
        self.offset = dist.get_rank(group)

    def __repr__(self):
        return f"ProcessGroupAxis(size={self.size}, rank={self.offset})"

    @classmethod
    def from_env(cls, device) -> "ProcessGroupAxis":
        """Join the process group a launcher describes in the environment
        (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
        ``LOCAL_RANK`` for the card): NCCL for a CUDA ``device``, gloo for
        the CPU. The axis is the whole world."""
        join_from_env(device)
        return cls()

    def _exchange(self, x, chunk):
        b = x.shape[0]
        # all_to_all_single splits dim 0 over the ranks: put the
        # destination shard first, and the source shard back after
        send = x.view(b, self.size, chunk).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.transpose(0, 1).contiguous().view(x.shape)

    def gather(self, x):
        x = x.contiguous()
        b = x.shape[0]
        out = torch.empty((self.size * b, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)  # rank-major concatenation
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.view(self.size, b, -1).transpose(0, 1).reshape(b, -1)

    def gather_rows(self, x):
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)  # rank-major = shard order
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce(self, t, op="sum"):
        t = t.clone()
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        return t


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def join_from_env(device) -> None:
    """Join the default process group a launcher describes in the
    environment, once: NCCL for a CUDA ``device`` (on the card
    ``LOCAL_RANK``), gloo for the CPU."""
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)


class Mesh:
    """The axes of one solve by role, in `AXIS_ORDER`, and ``batch``: the
    pod × data rows of the solver pool as one axis (the JAX pool's
    ``P(("pod", "data"))``; the `data` or `pod` axis alone where the other
    is absent, None where both are)."""

    def __init__(self, axes: dict, batch=None):
        self.axes = {r: axes[r] for r in AXIS_ORDER if r in axes}
        self.batch = batch

    @property
    def shape(self) -> dict:
        """{role: size}, as the JAX ``mesh.shape``."""
        return {r: a.size for r, a in self.axes.items()}

    @property
    def data_axes(self) -> tuple:
        """The batch roles present, outermost first (``compat.mesh_data_axes``)."""
        return tuple(r for r in ("pod", "data") if r in self.axes)

    @property
    def model(self):
        """The `model` axis, or None."""
        return self.axes.get("model")

    def over(self, roles) -> _Axis:
        """The axis the batch ``roles`` span together: one role's own axis,
        or `batch` for (pod, data)."""
        roles = tuple(roles)
        if len(roles) == 1:
            return self.axes[roles[0]]
        if roles == ("pod", "data"):
            return self.batch
        raise ValueError(f"no pool axis over {roles}")

    def __repr__(self):
        if len(self.axes) == 1:
            return repr(next(iter(self.axes.values())))
        return "Mesh(" + ", ".join(f"{r}={a!r}" for r, a in self.axes.items()) + ")"

    @classmethod
    def local(cls, spec: dict) -> "Mesh":
        """Every shard of every axis in this process."""
        axes = {r: LocalAxis(int(s)) for r, s in spec.items()}
        batch = None
        if "pod" in spec or "data" in spec:
            batch = LocalAxis(int(spec.get("pod", 1)) * int(spec.get("data", 1)))
        return cls(axes, batch)

    @classmethod
    def from_env(cls, spec: dict, device) -> "Mesh":
        """One shard of every axis per rank of the world a launcher
        describes (``WORLD_SIZE`` = the product of the sizes). Rank r sits
        at the row-major position r of the mesh; each role's axis is the
        process group of the ranks that share every other coordinate.
        Every rank builds every group, in the same order, as
        ``dist.new_group`` requires; a mesh is built once per spec."""
        key = (tuple(spec.items()), torch.device(device).type)
        if key in _MESHES:
            return _MESHES[key]
        join_from_env(device)
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != mesh_spec_size(spec):
            raise ValueError(f"mesh {spec} needs {mesh_spec_size(spec)} "
                             f"processes; the launcher started {world}")
        roles = list(spec)
        sizes = [int(spec[r]) for r in roles]
        grid = np.arange(world).reshape(sizes)

        def axis_along(dims):
            """This rank's axis over the grid dimensions ``dims``: the
            group of the ranks that share every other coordinate (every
            such group is created on every rank)."""
            span = int(np.prod([sizes[d] for d in dims]))
            if span == 1:
                return LocalAxis(1)
            if span == world:
                return ProcessGroupAxis(None)
            rest = [d for d in range(len(sizes)) if d not in dims]
            mine = None
            for coord in itertools.product(*(range(sizes[d]) for d in rest)):
                sub = grid
                for d, c in sorted(zip(rest, coord), reverse=True):
                    sub = np.take(sub, c, axis=d)
                ranks = sorted(int(x) for x in sub.reshape(-1))
                group = dist.new_group(ranks)
                if rank in ranks:
                    mine = group
            return ProcessGroupAxis(mine)

        axes = {r: axis_along([i]) for i, r in enumerate(roles)}
        batch_dims = [i for i, r in enumerate(roles) if r in ("pod", "data")]
        batch = None
        if len(batch_dims) == 1:
            batch = axes[roles[batch_dims[0]]]
        elif batch_dims:
            batch = axis_along(batch_dims)
        mesh = _MESHES[key] = cls(axes, batch)
        return mesh


_MESHES: dict = {}  # meshes over process groups, by (spec, device type)
