"""Diagonal objective of basis states: CUDA kernels and wrappers.

The counterpart of ``repro/kernels/cutvals.py``, batched: edges (B, E, 2)
int32, weights (B, E) f32, optional linear (B, n) f32 folded in as
virtual-bit rows (`ref.append_linear_rows`) so the kernel body stays the
XOR form. `cutvals` scores every state x < 2^n (the Pallas ``_kernel``,
``cutvals.py:47-90``); `cutvals_at` scores the states an (S, L) index
table names (``_at_kernel``, ``cutvals.py:108-166``), the layout-A/B cut
tables of the sharded statevector. Both kernels are ``csrc/cutvals.cu``;
their plain versions are `ref.cutvals` and `ref.cutvals_at`.

Knobs (through `tuning.param`, keys ``cutvals`` and ``cutvals_at``):
``tile_b``, states per block, and ``edge_chunk``, edges staged in shared
memory at a time. Neither changes a bit of the result: every state adds
its edges in edge order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

TILE_B = 256  # states per block: one per thread of a 256-thread block
EDGE_CHUNK = 1024  # edges staged at a time; the shared arrays hold 1024
MAX_TILE_B = 2048  # 8 states per thread


def knobs(op: str, dim: int, device) -> tuple[int, int]:
    """(tile_b, edge_chunk) for ``op`` over ``dim`` states a row; raises on
    a value the kernel does not take (no clamp: the kernel masks the
    ragged end of a row itself)."""
    tile_b = tuning.param(op, dim, "tile_b", TILE_B, device)
    chunk = tuning.param(op, dim, "edge_chunk", EDGE_CHUNK, device)
    if not tuning.is_pow2(tile_b) or not 32 <= tile_b <= MAX_TILE_B:
        raise ValueError(f"{op} tile_b {tile_b} outside the kernel's range: "
                         f"a power of two in [32, {MAX_TILE_B}]")
    if not 1 <= chunk <= EDGE_CHUNK:
        raise ValueError(f"{op} edge_chunk {chunk} outside [1, {EDGE_CHUNK}]")
    return tile_b, chunk


def cutvals(n: int, edges: torch.Tensor, weights: torch.Tensor,
            linear: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 2^n) f32 objective values; the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not 1 <= n <= 29:
        raise ValueError(f"n={n} outside [1, 29] (int32 basis, virtual bit 30)")
    if linear is not None:
        edges, weights = ref.append_linear_rows(edges, weights, linear)
    if not _build.on_cuda(edges):
        return ref.cutvals(n, edges, weights)
    b, e = edges.shape[0], edges.shape[1]
    edges = edges.contiguous()
    weights = weights.contiguous()
    _build.require(edges, "edges", torch.int32, (b, e, 2), edges.device)
    _build.require(weights, "weights", torch.float32, (b, e), edges.device)
    tile_b, chunk = knobs("cutvals", 2**n, edges.device)
    out = torch.empty((b, 2**n), dtype=torch.float32, device=edges.device)
    rc = _build.entry("cutvals")(
        edges.data_ptr(), weights.data_ptr(), out.data_ptr(), b, e, n,
        tile_b, chunk, _build.stream(edges.device))
    _build.check(rc, "cutvals")
    _build.count_launch("cutvals")
    return out


def cutvals_at(idx: torch.Tensor, edges: torch.Tensor, weights: torch.Tensor,
               linear: torch.Tensor | None = None) -> torch.Tensor:
    """(B·S, L) f32: row b·S + s scores edge row b at the basis states
    idx[s], for an (S, L) int32 table shared by every edge row (indices
    below 2^29: the virtual bit 30 must stay clear)."""
    if linear is not None:
        edges, weights = ref.append_linear_rows(edges, weights, linear)
    if not _build.on_cuda(edges):
        return ref.cutvals_at(idx, edges, weights)
    b, e = edges.shape[0], edges.shape[1]
    s, width = idx.shape
    dev = edges.device
    edges = edges.contiguous()
    weights = weights.contiguous()
    _build.require(idx, "idx", torch.int32, (s, width), dev)
    _build.require(edges, "edges", torch.int32, (b, e, 2), dev)
    _build.require(weights, "weights", torch.float32, (b, e), dev)
    tile_b, chunk = knobs("cutvals_at", idx.numel(), dev)
    out = torch.empty((b * s, width), dtype=torch.float32, device=dev)
    rc = _build.entry("cutvals_at")(
        idx.data_ptr(), edges.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, s, width, e, tile_b, chunk, _build.stream(dev))
    _build.check(rc, "cutvals_at")
    _build.count_launch("cutvals_at")
    return out
