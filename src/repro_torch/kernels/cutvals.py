"""Diagonal objective of basis states: CUDA kernels and wrappers.

The counterpart of ``repro/kernels/cutvals.py``, batched: edges (B, E, 2)
int32, weights (B, E) f32, optional linear (B, n) f32 folded in as
virtual-bit rows (`ref.append_linear_rows`). `cutvals` scores every state
x < 2^n (the Pallas ``_kernel``, ``cutvals.py:47-90``); `cutvals_at`
scores the states an (S, L) index table names (``_at_kernel``,
``cutvals.py:108-166``), the layout-A/B cut tables of the sharded
statevector. Both are a table lookup: a table pass builds T_lo, T_hi and D
per edge row (`split_tables`), and a second kernel computes
c = T_lo[lo] + T_hi[hi] + Σ_{j set in lo} D[hi, j] for each state, lo its
low ``LO_BITS`` bits: the fill kernel for every state in order (it reads
no index), the expand kernel for the states of an index table. All are
``csrc/cutvals.cu``; the plain versions are `ref.cutvals` and
`ref.cutvals_at` (edge order), and `ref.cutvals_split_tables`,
`ref.cutvals_split` and `ref.cutvals_at_split` mirror the table design on
the CPU.

Knobs (through `tuning.param`): ``cutvals`` and ``cutvals_at`` each take
``tile_b``, states per block (the table pass has no knob). Neither changes
a bit of the result.

Exactness: both add in table order (T_lo, then T_hi, then D[hi, j] in
increasing j), not in the plain version's edge order. Integer weights and
linear terms give exact integers (every partial sum is an integer below
2^24), equal to the plain version's bits; real ones agree with it within
``CUTVALS_AT_RTOL · (Σ|w| + Σ|h|)`` of their edge row a state, and equal
the mirror bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

TILE_B = 1024  # cutvals' states per block: 4 per thread
MAX_TILE_B = 2048  # 8 states per thread
AT_TILE_B = 1024  # cutvals_at's states per block: 4 per thread
LO_BITS = ref.CUTVALS_LO_BITS  # l = min(n, 12): T_lo holds 2^l values a row
RECORD = 16  # floats a hi record on the card: D[hi, 0..11], T_hi[hi], 3 zeros
# of Σ|w| + Σ|h|: either kernel's real weights against the plain version
CUTVALS_AT_RTOL = 8 * 2.0**-24


def tile_b_knob(op: str, dim: int, default: int, device) -> int:
    """``op``'s states per block over ``dim`` states; raises on a value the
    kernel does not take (no clamp: the kernel masks the ragged end of a
    row itself)."""
    tile_b = tuning.param(op, dim, "tile_b", default, device)
    if not tuning.is_pow2(tile_b) or not 32 <= tile_b <= MAX_TILE_B:
        raise ValueError(f"{op} tile_b {tile_b} outside the kernel's range: "
                         f"a power of two in [32, {MAX_TILE_B}]")
    return tile_b


def _edge_arrays(edges, weights, dev):
    b, e = edges.shape[0], edges.shape[1]
    edges, weights = edges.contiguous(), weights.contiguous()
    _build.require(edges, "edges", torch.int32, (b, e, 2), dev)
    _build.require(weights, "weights", torch.float32, (b, e), dev)
    return edges, weights


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
    t_lo, hd = _tables(edges, weights, n)
    dev = edges.device
    tile_b = tile_b_knob("cutvals", 2**n, TILE_B, dev)
    out = torch.empty((edges.shape[0], 2**n), dtype=torch.float32, device=dev)
    rc = _build.entry("cutvals")(
        t_lo.data_ptr(), hd.data_ptr(), out.data_ptr(), edges.shape[0], n, tile_b,
        _build.stream(dev))
    _build.check(rc, "cutvals")
    _build.count_launch("cutvals")
    return out


def _tables(edges, weights, n: int):
    """The table pass on the card: (T_lo (B, 2^l), hd (B, 2^(n-l), 16)),
    each record of hd (D[hi, 0..11], T_hi[hi], 0, 0, 0)."""
    dev = edges.device
    edges, weights = _edge_arrays(edges, weights, dev)
    b = edges.shape[0]
    l = min(n, LO_BITS)
    t_lo = torch.empty((b, 2**l), dtype=torch.float32, device=dev)
    hd = torch.empty((b, 2 ** (n - l), RECORD), dtype=torch.float32, device=dev)
    rc = _build.entry("cutvals_tables")(
        edges.data_ptr(), weights.data_ptr(), t_lo.data_ptr(), hd.data_ptr(), b,
        edges.shape[1], n, _build.stream(dev))
    _build.check(rc, "cutvals_tables")
    return t_lo, hd


def split_tables(edges: torch.Tensor, weights: torch.Tensor, n: int,
                 linear: torch.Tensor | None = None):
    """(T_lo (B, 2^l), T_hi (B, 2^(n-l)), D (B, 2^(n-l), l)) f32 with
    l = min(n, LO_BITS): the table pass of `cutvals` and `cutvals_at` (one
    launch on the card, `ref.cutvals_split_tables` on the CPU)."""
    if not 1 <= n <= 29:
        raise ValueError(f"n={n} outside [1, 29] (int32 basis, virtual bit 30)")
    if linear is not None:
        edges, weights = ref.append_linear_rows(edges, weights, linear)
    if not _build.on_cuda(edges):
        return ref.cutvals_split_tables(edges, weights, n)
    t_lo, hd = _tables(edges, weights, n)
    return t_lo, hd[..., LO_BITS], hd[..., : min(n, LO_BITS)]


def index_bits(idx: torch.Tensor) -> int:
    """The least n with every index of ``idx`` below 2^n (at least 1): one
    read of ``idx.max()``, a host synchronisation."""
    top = int(idx.max()) if idx.numel() else 0
    return max(1, top.bit_length())


def cutvals_at(idx: torch.Tensor, edges: torch.Tensor, weights: torch.Tensor,
               linear: torch.Tensor | None = None, *,
               n_bits: int | None = None) -> torch.Tensor:
    """(B·S, L) f32: row b·S + s scores edge row b at the basis states
    idx[s], for an (S, L) int32 table shared by every edge row. Every
    index must lie below 2^n_bits (the kernel traps otherwise); ``n_bits``
    None reads ``idx.max()`` once (a host sync) to find it. Indices stay
    below 2^29: the virtual bit 30 must stay clear."""
    if not _build.on_cuda(edges):
        return ref.cutvals_at(idx, edges, weights, linear)
    s, width = idx.shape
    dev = edges.device
    _build.require(idx, "idx", torch.int32, (s, width), dev)
    n = index_bits(idx) if n_bits is None else n_bits
    if not 1 <= n <= 29:
        raise ValueError(f"n_bits={n} outside [1, 29] (int32 basis, virtual bit 30)")
    if linear is not None:
        edges, weights = ref.append_linear_rows(edges, weights, linear)
    t_lo, hd = _tables(edges, weights, n)
    b = t_lo.shape[0]
    tile_b = tile_b_knob("cutvals_at", idx.numel(), AT_TILE_B, dev)
    out = torch.empty((b * s, width), dtype=torch.float32, device=dev)
    rc = _build.entry("cutvals_at")(
        idx.data_ptr(), t_lo.data_ptr(), hd.data_ptr(), out.data_ptr(), b, s, width,
        n, tile_b, _build.stream(dev))
    _build.check(rc, "cutvals_at")
    _build.count_launch("cutvals_at")
    return out
