"""The `model` mesh axis of the sharded statevector, as an object.

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
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


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
    size: int  # D: shards of one statevector, a power of two
    local: int  # shards of each subgraph held by this process
    offset: int  # shard index of the first of them

    @property
    def h(self) -> int:
        """log2(D): the qubits that live on the axis ("global" qubits)."""
        return self.size.bit_length() - 1

    def swap(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        """Layout A <-> layout B of (B·local, D·chunk) planes: shard p's
        block d goes to shard d's block p (``engine.py:171-178``)."""
        return _Swap.apply(x, self, chunk)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(B·local, ...) per-shard values → (B, ...) sums over the axis
        (the ``psum``), the same on every process."""
        return self.reduce(x.reshape(-1, self.local, *x.shape[1:]).sum(1))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B·local, k) → (B, D·k): every shard's row, in shard order (the
        ``all_gather``), the same on every process."""
        raise NotImplementedError

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a per-subgraph tensor over the processes of the axis."""
        raise NotImplementedError

    def _exchange(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        raise NotImplementedError


class LocalAxis(_Axis):
    """Every shard of the axis in this process, as rows (subgraph, shard)."""

    def __init__(self, size: int):
        if size < 1 or size & (size - 1):
            raise ValueError(f"axis size {size} must be a power of two")
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

    def reduce(self, t):
        return t


class ProcessGroupAxis(_Axis):
    """One shard per rank of a ``torch.distributed`` process group."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        if self.size & (self.size - 1):
            raise ValueError(f"axis size {self.size} must be a power of two")
        self.local = 1
        self.offset = dist.get_rank(group)

    def __repr__(self):
        return f"ProcessGroupAxis(size={self.size}, rank={self.offset})"

    @classmethod
    def from_env(cls, device) -> "ProcessGroupAxis":
        """Join the process group a launcher describes in the environment
        (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
        ``LOCAL_RANK`` for the card): NCCL for a CUDA ``device``, gloo for
        the CPU."""
        if not dist.is_initialized():
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

    def reduce(self, t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t
