"""Cut values of a batch of ±1 spin rows: CUDA kernel and wrapper.

The counterpart of ``repro/kernels/cutbatch.py``:
cut_b = (W_tot − ½ s_bᵀ A s_b) / 2 for spins (B, V) f32 in {−1, +1}, a
dense symmetric adjacency A (V, V) f32 and W_tot = Σw. The kernel is
``csrc/cutbatch.cu``, a tiled f32 product with the quadratic-form epilogue
fused and a fixed-order second pass (no atomics); its plain version is
`ref.cut_batch_dense`.

Knobs (through `tuning.param`, key ``cut_batch_dense``, bucket by V):
``batch_tile``, spin rows per block, and ``k_chunk``, the K slice staged
in shared memory. Neither changes a bit of the result. V and B need not
divide them: the kernel masks the ragged edges itself, so the wrapper
makes no padded copy of A.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

BATCH_TILE = 128
K_CHUNK = 16
BATCH_TILES = (32, 64, 128)  # the kernel's instances
K_CHUNKS = (8, 16, 32)
SPAN = 128  # columns per block: one partial per (row, span)


def knobs(v: int, device) -> tuple[int, int]:
    """(batch_tile, k_chunk) for V columns; raises on a value the kernel
    has no instance for."""
    bt = tuning.param("cut_batch_dense", v, "batch_tile", BATCH_TILE, device)
    kc = tuning.param("cut_batch_dense", v, "k_chunk", K_CHUNK, device)
    if bt not in BATCH_TILES or kc not in K_CHUNKS:
        raise ValueError(f"cut_batch_dense (batch_tile, k_chunk) = ({bt}, {kc}) "
                         f"outside the kernel's instances {BATCH_TILES} x {K_CHUNKS}")
    return bt, kc


def cut_batch_dense(spins: torch.Tensor, adjacency: torch.Tensor,
                    total_weight) -> torch.Tensor:
    """(B,) f32 cut values; ``total_weight`` a float or a one-element tensor
    (kept on the device: the wrapper never reads it back)."""
    if not _build.on_cuda(spins):
        return ref.cut_batch_dense(spins, adjacency, total_weight)
    b, v = spins.shape
    dev = spins.device
    _build.require(spins, "spins", torch.float32, (b, v), dev)
    _build.require(adjacency, "adjacency", torch.float32, (v, v), dev)
    wtot = torch.as_tensor(total_weight, dtype=torch.float32, device=dev)
    wtot = wtot.reshape(1).contiguous()
    bt, kc = knobs(v, dev)
    partial = torch.empty((b, (v + SPAN - 1) // SPAN), dtype=torch.float32,
                          device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.entry("cut_batch_dense")(
        spins.data_ptr(), adjacency.data_ptr(), wtot.data_ptr(),
        partial.data_ptr(), out.data_ptr(), b, v, bt, kc, _build.stream(dev))
    _build.check(rc, "cut_batch_dense")
    _build.count_launch("cut_batch_dense")
    return out
