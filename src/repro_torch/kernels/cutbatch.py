"""Cut values of a batch of ±1 spin rows: CUDA kernels and wrapper.

The counterpart of ``repro/kernels/cutbatch.py``:
cut_b = (W_tot − ½ s_bᵀ A s_b) / 2 for spins (B, V) f32 in {−1, +1}, a
dense adjacency A (V, V) f32 and W_tot = Σw. The kernels are
``csrc/cutbatch.cu``: a split pass writes A as three bf16 planes
A₁ + A₂ + A₃ = A (exactly) with one device-side flag a plane, then a
bf16 tensor-core product (``mma.sync`` m16n8k16, f32 accumulators, a
cp.async ring of shared-memory stages) of the spin rows, cast once to a
padded bf16 copy (exact for ±1), with each nonzero plane, the
quadratic-form epilogue fused, and a fixed-order second pass (no
atomics). Spins must be ±1 (or 0): other values would round to bf16. The plain version is
`ref.cut_batch_dense`; `ref.split_bf16` and `ref.cut_batch_dense_split`
mirror the decomposition on the CPU.

Knobs (through `tuning.param`, key ``cut_batch_dense``, bucket by V):
``batch_tile``, spin rows per block, and ``k_chunk``, the K slice staged
in shared memory. Neither changes a bit of the result (the order of every
addition depends on V only). B and V need not divide them: the kernel
masks ragged spin rows itself and the planes are padded with zeros, so the
wrapper makes no padded copy of A.

Exactness: integer weights give exact cut values, equal to the plain
version's bits (|w| ≤ 256 leaves A₂ = A₃ = 0, so one product runs). Real
weights agree with the plain version within ``CUT_BATCH_RTOL · Σ|A|`` a
cut value: both sum the same exact terms s_r A_rc s_c in f32, in another
order, each with a rounding error of a few units of 2⁻²⁴ of Σ|terms|.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

BATCH_TILE = 128
K_CHUNK = 64
BATCH_TILES = (64, 128)  # the kernel's instances
K_CHUNKS = (32, 64)
SPAN = 128  # columns per block: one partial per (row, span)
ROW_ALIGN, COL_ALIGN = 128, 64  # the planes' zero padding
CUT_BATCH_RTOL = 8 * 2.0**-24  # of Σ|A|: real weights against the plain version


def knobs(v: int, device) -> tuple[int, int]:
    """(batch_tile, k_chunk) for V columns; raises on a value the kernel
    has no instance for."""
    bt = tuning.param("cut_batch_dense", v, "batch_tile", BATCH_TILE, device)
    kc = tuning.param("cut_batch_dense", v, "k_chunk", K_CHUNK, device)
    if bt not in BATCH_TILES or kc not in K_CHUNKS:
        raise ValueError(f"cut_batch_dense (batch_tile, k_chunk) = ({bt}, {kc}) "
                         f"outside the kernel's instances {BATCH_TILES} x {K_CHUNKS}")
    return bt, kc


def _split(adjacency: torch.Tensor, alloc=torch.empty):
    """(planes (3, Vn, Vk) bf16 zero-padded, flags (3,) int32) on the card.
    A plane whose flag is clear is left as ``alloc`` made it: the product
    never reads it."""
    v = adjacency.shape[0]
    dev = adjacency.device
    _build.require(adjacency, "adjacency", torch.float32, (v, v), dev)
    vn, vk = tuning.round_up(v, ROW_ALIGN), tuning.round_up(v, COL_ALIGN)
    planes = alloc((3, vn, vk), dtype=torch.bfloat16, device=dev)
    flags = torch.empty((3,), dtype=torch.int32, device=dev)
    rc = _build.entry("cut_batch_split")(
        adjacency.data_ptr(), planes.data_ptr(), flags.data_ptr(), v, vn, vk,
        _build.stream(dev))
    _build.check(rc, "cut_batch_split")
    return planes, flags


def split_planes(adjacency: torch.Tensor):
    """``((A₁, A₂, A₃), flags)``: the bf16 planes of A, each (V, V), and
    whether each holds a nonzero entry ((3,) int32; on the card without a
    read-back). On the CPU, `ref.split_bf16`."""
    if not _build.on_cuda(adjacency):
        planes = ref.split_bf16(adjacency)
        return planes, torch.stack([(p != 0).any() for p in planes]).to(torch.int32)
    v = adjacency.shape[0]
    planes, flags = _split(adjacency, torch.zeros)
    return tuple(p[:v, :v] for p in planes), flags


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
    planes, flags = _split(adjacency)
    vn, vk = planes.shape[1], planes.shape[2]
    spins_bf16 = torch.empty((tuning.round_up(b, ROW_ALIGN), vk), dtype=torch.bfloat16,
                             device=dev)
    partial = torch.empty((b, (v + SPAN - 1) // SPAN), dtype=torch.float32,
                          device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.entry("cut_batch_dense")(
        spins.data_ptr(), spins_bf16.data_ptr(), planes.data_ptr(), flags.data_ptr(),
        wtot.data_ptr(), partial.data_ptr(), out.data_ptr(), b, v, vn, vk, bt, kc,
        _build.stream(dev))
    _build.check(rc, "cut_batch_dense")
    _build.count_launch("cut_batch_dense")
    return out
