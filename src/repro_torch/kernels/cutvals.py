"""Diagonal objective of basis states: CUDA kernels and wrappers.

The counterpart of ``repro/kernels/cutvals.py``, batched: edges (B, E, 2)
int32, weights (B, E) f32, optional linear (B, n) f32 folded in as
virtual-bit rows (`ref.append_linear_rows`) so the kernel body stays the
XOR form. `cutvals` scores every state x < 2^n (the Pallas ``_kernel``,
``cutvals.py:47-90``); `cutvals_at` scores the states an (S, L) index
table names (``_at_kernel``, ``cutvals.py:108-166``), the layout-A/B cut
tables of the sharded statevector. Both kernels are ``csrc/cutvals.cu``;
their plain versions are `ref.cutvals` and `ref.cutvals_at`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref


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
    out = torch.empty((b, 2**n), dtype=torch.float32, device=edges.device)
    rc = _build.entry("cutvals")(
        edges.data_ptr(), weights.data_ptr(), out.data_ptr(), b, e, n,
        _build.stream(edges.device))
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
    out = torch.empty((b * s, width), dtype=torch.float32, device=dev)
    rc = _build.entry("cutvals_at")(
        idx.data_ptr(), edges.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, s, width, e, _build.stream(dev))
    _build.check(rc, "cutvals_at")
    _build.count_launch("cutvals_at")
    return out
