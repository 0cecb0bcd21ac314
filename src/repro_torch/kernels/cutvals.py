"""Diagonal objective of every basis state: CUDA kernel and wrapper.

The counterpart of ``repro/kernels/cutvals.py::cutvals`` (the Pallas
kernel at ``cutvals.py:47-90``), batched: edges (B, E, 2) int32, weights
(B, E) f32, optional linear (B, n) f32 folded in as virtual-bit rows
(`ref.append_linear_rows`) so the kernel body stays the XOR form. The
kernel is ``csrc/cutvals.cu``; its plain version is `ref.cutvals`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

launches = 0  # kernel launches through `cutvals` since the last reset


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
    global launches
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
    launches += 1
    return out
