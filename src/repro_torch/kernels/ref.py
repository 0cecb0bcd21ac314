"""Plain PyTorch versions of every kernel on the solve path, batched.

The counterpart of ``repro/kernels/ref.py`` with the ``vmap`` written out:
every state tensor carries a leading batch axis B (one row per subgraph)
and every angle is a (B,) tensor, one value per row. These functions are
the semantics each CUDA kernel is held against, the branch the wrappers
take for CPU tensors, and the yardstick ``chip_smoke.py`` times.

Complex statevectors are (re, im) float32 planes of shape (B, 2^n).
Bit convention: basis index ``b`` gives qubit ``q`` the bit ``(b >> q) & 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Linear (per-vertex) terms fold into the XOR edge form through a virtual
# bit: h_v * bit_v(b) == h_v * (bit_v(b) XOR bit_30(b)) because bit 30 of
# any int32 basis index is 0 for n <= 29. One appended row (v, 30, h_v) per
# vertex makes the unchanged XOR kernel score quadratic + linear terms.
VIRTUAL_BIT = 30
CUTVALS_LO_BITS = 12  # the table design's split: lo = the low min(n, 12) bits
BETA_TILE = 4096  # ∂β kernel: amplitudes a tile stages of each plane
BETA_LANES = 16  # ∂β kernel: least lanes of Y a tile takes where Y allows (64 B)
BETA_MAX_K = 12  # ∂β kernel: qubits a group
BETA_SLOTS = 16  # ∂β kernel: leaves of an amplitude's pairwise tree


def append_linear_rows(edges: torch.Tensor, weights: torch.Tensor,
                       linear: torch.Tensor):
    """Append one (v, VIRTUAL_BIT, h_v) row per vertex to batched edge arrays.

    edges (B, E, 2) int32, weights (B, E) f32, linear (B, n) f32.
    """
    b, n = linear.shape
    v = torch.arange(n, dtype=torch.int32, device=edges.device)
    extra = torch.stack([v, torch.full_like(v, VIRTUAL_BIT)], dim=1)
    extra = extra.unsqueeze(0).expand(b, n, 2)
    return (torch.cat([edges, extra], dim=1),
            torch.cat([weights, linear.to(weights.dtype)], dim=1))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count for non-negative int32 tensors (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def cutvals(n: int, edges: torch.Tensor, weights: torch.Tensor,
            linear: torch.Tensor | None = None) -> torch.Tensor:
    """Objective value of every basis state of every row: (B, 2^n) f32."""
    idx = torch.arange(2**n, dtype=torch.int32, device=edges.device)[None, :]
    return cutvals_at(idx, edges, weights, linear)


def cutvals_at(idx: torch.Tensor, edges: torch.Tensor, weights: torch.Tensor,
               linear: torch.Tensor | None = None) -> torch.Tensor:
    """Objective values at the basis states of an (S, L) int32 table for
    every edge row: (B·S, L) f32, row b·S + s = edge row b at idx[s].

    Accumulates in f32 in edge order, one edge at a time, so integer
    weights give exact integers. Padding rows (0, 0, w=0) add zero.
    """
    if linear is not None:
        edges, weights = append_linear_rows(edges, weights, linear)
    b, (s, width) = edges.shape[0], idx.shape
    acc = torch.zeros((b, s, width), dtype=torch.float32, device=edges.device)
    for e in range(edges.shape[1]):
        i = edges[:, e, 0].view(b, 1, 1)
        j = edges[:, e, 1].view(b, 1, 1)
        crossed = ((idx >> i) ^ (idx >> j)) & 1
        acc = acc + weights[:, e].view(b, 1, 1) * crossed.to(torch.float32)
    return acc.view(b * s, width)


def cutvals_split_tables(edges: torch.Tensor, weights: torch.Tensor, n: int,
                         l: int | None = None):
    """The tables of the lookup form of `cutvals_at` for x < 2^n, split into
    lo = its low l bits (default min(n, CUTVALS_LO_BITS)) and hi = the rest:
    (T_lo (B, 2^l), T_hi (B, 2^(n-l)), D (B, 2^(n-l), l)) f32 with

        c(x) = T_lo[lo] + T_hi[hi] + Σ_{j < l, bit j of lo set} D[hi, j].

    Edge by edge, with a ⊕ b = a + b − 2ab: both ends in lo add
    w·(bit_i ⊕ bit_j) to T_lo; both in hi to T_hi; i in hi and j in lo add
    w·bit_i to T_hi and w·(1 − 2 bit_i) to D[·, j]; an end at a bit ≥ n
    (the virtual bit 30 of a linear row, or any bit an index below 2^n
    leaves clear) leaves w·bit of the other end, on its side. Each entry
    adds its edges in edge order, as the CUDA table pass does, so the two
    are equal bit for bit.
    """
    l = min(n, CUTVALS_LO_BITS) if l is None else l
    h = n - l
    b = edges.shape[0]
    dev = edges.device
    lo = torch.arange(2**l, dtype=torch.int64, device=dev)
    hi = torch.arange(2**h, dtype=torch.int64, device=dev)
    t_lo = torch.zeros((b, 2**l), dtype=torch.float32, device=dev)
    t_hi = torch.zeros((b, 2**h), dtype=torch.float32, device=dev)
    d = torch.zeros((b, 2**h, l), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ee = edges.cpu().tolist()
    for r in range(b):
        for e in range(edges.shape[1]):
            i, j = ee[r][e]
            w = weights[r, e]
            zi, zj = not 0 <= i < n, not 0 <= j < n
            if i == j or (zi and zj):
                continue
            if zi or (not zj and i < l <= j):  # the zero or the hi end first
                i, j = j, i
            if zi or zj:  # w * bit_i
                if i < l:
                    t_lo[r] = t_lo[r] + torch.where((lo >> i) & 1 == 1, w, zero)
                else:
                    t_hi[r] = t_hi[r] + torch.where((hi >> (i - l)) & 1 == 1, w, zero)
            elif i < l and j < l:
                t_lo[r] = t_lo[r] + torch.where(((lo >> i) ^ (lo >> j)) & 1 == 1, w, zero)
            elif j >= l:
                t_hi[r] = t_hi[r] + torch.where(
                    ((hi >> (i - l)) ^ (hi >> (j - l))) & 1 == 1, w, zero)
            else:  # i in hi, j in lo
                bi = (hi >> (i - l)) & 1 == 1
                t_hi[r] = t_hi[r] + torch.where(bi, w, zero)
                d[r, :, j] = d[r, :, j] + torch.where(bi, -w, w)
    return t_lo, t_hi, d


def cutvals_at_split(idx: torch.Tensor, tables, l: int | None = None) -> torch.Tensor:
    """`cutvals_at` from the tables of `cutvals_split_tables`: (B·S, L) f32,
    c = T_lo[lo] + T_hi[hi], then D[hi, j] for each set bit j of lo in
    increasing j, as the CUDA expand kernel adds them."""
    t_lo, t_hi, d = tables
    l = d.shape[2] if l is None else l
    b, (s, width) = t_lo.shape[0], idx.shape
    x = idx.long()
    lo, hi = x & (2**l - 1), x >> l
    c = t_lo[:, lo] + t_hi[:, hi]  # (B, S, L)
    for j in range(l):
        c = torch.where(((lo >> j) & 1 == 1)[None], c + d[:, :, j][:, hi], c)
    return c.reshape(b * s, width)


def cutvals_split(n: int, edges: torch.Tensor, weights: torch.Tensor,
                  linear: torch.Tensor | None = None) -> torch.Tensor:
    """`cutvals` through the tables of `cutvals_split_tables`, as the CUDA
    fill kernel computes it: (B, 2^n) f32, `cutvals_at_split` of the
    identity table."""
    if linear is not None:
        edges, weights = append_linear_rows(edges, weights, linear)
    idx = torch.arange(2**n, dtype=torch.int32, device=edges.device)[None, :]
    return cutvals_at_split(idx, cutvals_split_tables(edges, weights, n))


def apply_phase(re, im, cutv, gamma):
    """Diagonal cost layer psi <- exp(-i gamma c) psi, gamma (B,)."""
    g = gamma.reshape((-1,) + (1,) * (re.dim() - 1))
    c = torch.cos(g * cutv)
    s = torch.sin(g * cutv)
    return re * c + im * s, im * c - re * s


def rx_kron_parts(beta: torch.Tensor, k: int):
    """(C, D), each (B, 2^k, 2^k), with C + iD = RX(2 beta)^{⊗k} per row.

    Entry [a, b] = cos(beta)^(k-d) * (-i sin(beta))^d with d = popcount(a^b).
    Integer powers come from cumulative-product tables, so negative bases
    keep their exact sign.
    """
    a = torch.arange(2**k, dtype=torch.int32, device=beta.device)
    d = popcount(a[:, None] ^ a[None, :]).long()
    cb, sb = torch.cos(beta), torch.sin(beta)
    ones = torch.ones_like(cb)[:, None]
    cpow = torch.cumprod(torch.cat([ones, cb[:, None].expand(-1, k)], 1), 1)
    spow = torch.cumprod(torch.cat([ones, sb[:, None].expand(-1, k)], 1), 1)
    mag = cpow[:, k - d] * spow[:, d]  # (B, 2^k, 2^k)
    rfac = torch.tensor([1.0, 0.0, -1.0, 0.0], device=beta.device)[d % 4]
    ifac = torch.tensor([0.0, -1.0, 0.0, 1.0], device=beta.device)[d % 4]
    return mag * rfac, mag * ifac


def mixer_group(re3, im3, beta, k: int):
    """RX(2 beta)^{⊗k} on the group axis of (B, X, 2^k, Y) planes."""
    C, D = rx_kron_parts(beta, k)

    def mm(u, x):
        if u.shape[0] == 1:
            # a batch of one takes another BLAS route (a matrix-vector
            # product where X = Y = 1) than the same row among others: run
            # it as two rows, so a row's bits do not depend on its batch
            return torch.einsum("bac,bxcy->bxay", torch.cat([u, u]),
                                torch.cat([x, x]))[:1]
        return torch.einsum("bac,bxcy->bxay", u, x)

    return mm(C, re3) - mm(D, im3), mm(C, im3) + mm(D, re3)


def apply_mixer_bits(re, im, n: int, lo_bit: int, nbits: int, beta):
    """RX(2 beta)^{⊗nbits} on qubits [lo_bit, lo_bit + nbits) of (B, 2^n)."""
    b = re.shape[0]
    shape = (b, 2 ** (n - lo_bit - nbits), 2**nbits, 2**lo_bit)
    ore, oim = mixer_group(re.reshape(shape), im.reshape(shape), beta, nbits)
    return ore.reshape(b, -1), oim.reshape(b, -1)


def apply_mixer(re, im, n: int, beta, group: int = 7):
    """Full transverse-field mixer as ceil(n / group) grouped unitaries."""
    for g0 in range(0, n, group):
        re, im = apply_mixer_bits(re, im, n, g0, min(group, n - g0), beta)
    return re, im


def expectation(re, im, cutv):
    """<psi| diag(c) |psi> per row: (B,)."""
    return torch.sum((re * re + im * im) * cutv, dim=-1)


def phase_grad(re, im, g_re, g_im, cutv):
    """The phase rule's gamma cotangent, sum_x c (im g_re - re g_im) per
    row: (B,)."""
    return torch.sum(cutv * (im * g_re - re * g_im), dim=-1)


def cut_batch_dense(spins: torch.Tensor, adjacency: torch.Tensor, total_weight):
    """Cut values of ±1 spin rows through the dense adjacency: (B,) f32.

    spins (B, V) f32 in {-1, +1}, adjacency (V, V) f32 symmetric,
    total_weight Σw (a float or a one-element tensor).
    cut = (W_total - 0.5 * s^T A s) / 2   [0.5 because A counts each edge twice]
    """
    quad = torch.einsum("bi,ij,bj->b", spins, adjacency, spins)
    return _cut_from_quad(quad, total_weight)


def _cut_from_quad(quad, total_weight):
    if isinstance(total_weight, torch.Tensor):
        total_weight = total_weight.reshape(()).to(quad)
    return (total_weight - 0.5 * quad) / 2.0


def split_bf16(a: torch.Tensor):
    """(A₁, A₂, A₃) bf16 with A₁ + A₂ + A₃ = A exactly in f32:
    A₁ = bf16(A), A₂ = bf16(A − A₁), A₃ = bf16(A − A₁ − A₂). Each residual
    is exact in f32 and keeps at most 16, then 8 significant bits, so A₃
    holds the rest exactly (above bf16's subnormal range); integers
    |w| ≤ 256 give A₂ = A₃ = 0."""
    a1 = a.to(torch.bfloat16)
    r1 = a - a1.to(torch.float32)
    a2 = r1.to(torch.bfloat16)
    return a1, a2, (r1 - a2.to(torch.float32)).to(torch.bfloat16)


def cut_batch_dense_split(spins: torch.Tensor, adjacency: torch.Tensor,
                          total_weight) -> torch.Tensor:
    """`cut_batch_dense` through the bf16 planes of `split_bf16`, as the
    tensor-core kernel computes it: q = Σ_t s Aₜ sᵀ, one f32 product per
    plane, the planes in order."""
    quad = torch.zeros(spins.shape[0], dtype=torch.float32, device=spins.device)
    for plane in split_bf16(adjacency):
        quad = quad + torch.einsum("bi,ij,bj->b", spins, plane.to(torch.float32), spins)
    return _cut_from_quad(quad, total_weight)


def neighbor_sum_bits(v, lo_bit: int, nbits: int):
    """Σ over qubits q in [lo_bit, lo_bit + nbits) of v with bit q flipped:
    the ∂β generator contraction (each RX factor differentiates into −i·X
    on its qubit). Per qubit, the (B, -1, 2, 2^q) view pairs each index
    with its flip; adding the two halves crosswise in place is the
    ``flip(2)`` add without a temporary plane."""
    b = v.shape[0]
    out = torch.zeros_like(v)
    for q in range(lo_bit, lo_bit + nbits):
        o = out.view(b, -1, 2, 2**q)
        w = v.view(b, -1, 2, 2**q)
        o[:, :, 0].add_(w[:, :, 1])
        o[:, :, 1].add_(w[:, :, 0])
    return out


def beta_grad(d_ore, d_oim, ore, oim, lo_bit: int, nbits: int):
    """Per-row ∂β = Σ d_ore·N(oim) − Σ d_oim·N(ore), one neighbour-sum
    plane alive at a time."""
    fi = neighbor_sum_bits(oim, lo_bit, nbits)
    a = torch.sum(d_ore * fi, dim=-1)
    del fi
    fr = neighbor_sum_bits(ore, lo_bit, nbits)
    return a - torch.sum(d_oim * fr, dim=-1)


class BetaPass(NamedTuple):
    """One group of the ∂β kernel: qubits [g0, g0 + k) on the (B, X, 2^k,
    2^g0) view, tiles of 2^k × ``lanes`` amplitudes."""

    g0: int
    k: int
    lanes: int


def _beta_lanes(g0: int, k: int) -> int:
    """Lanes of Y = 2^g0 a tile of k qubits takes: all of Y where 2^k·Y
    fits BETA_TILE, else as many as fit."""
    return 2**g0 if 2**k * 2**g0 <= BETA_TILE else BETA_TILE >> k


def beta_grad_launches(lo_bit: int, nbits: int) -> list:
    """The ∂β kernel's reads of the planes over qubits [lo_bit, lo_bit +
    nbits): a list of launches, each a tuple of one `BetaPass` or two that
    share each region of the planes through L2 (one read of HBM for both).

    A group takes as many qubits (up to BETA_MAX_K) as fit one tile beside
    at least BETA_LANES lanes (all of Y where Y is smaller). Where the rest
    of the range does not fit one group but an even count of qubits, it is
    cut into two equal halves on the same lanes (at least BETA_LANES of
    them, at most Y) fused in one launch, if they fit, so both fill their
    tiles alike; else the most that fit go first. At n = 24: qubits 0-11
    on contiguous tiles, then 12-17 and 18-23 on runs of 64 lanes; at n =
    23: 0-11, then 12-19 on runs of 16 lanes, then 20-22."""
    launches, g0, end = [], lo_bit, lo_bit + nbits
    while g0 < end:
        y, rest = 2**g0, end - g0
        kmax = min(BETA_MAX_K, (BETA_TILE // min(y, BETA_LANES)).bit_length() - 1)
        if rest <= kmax:
            launches.append((BetaPass(g0, rest, _beta_lanes(g0, rest)),))
            break
        k1 = rest // 2
        lanes = BETA_TILE >> k1
        if rest % 2 == 0 and k1 <= BETA_MAX_K and BETA_LANES <= lanes <= y:
            launches.append((BetaPass(g0, k1, lanes), BetaPass(g0 + k1, rest - k1, lanes)))
            break
        launches.append((BetaPass(g0, kmax, _beta_lanes(g0, kmax)),))
        g0 += kmax
    return launches


def beta_grad_groups(lo_bit: int, nbits: int) -> list:
    """Every `BetaPass` of `beta_grad_launches`, in order."""
    return [p for launch in beta_grad_launches(lo_bit, nbits) for p in launch]


def beta_pass_tiles(n: int, p: BetaPass):
    """(slabs, partials a row) of group ``p`` on an n-qubit state: a tile
    that takes all of Y also takes consecutive x up to BETA_TILE
    amplitudes; each tile writes one partial."""
    x = 2 ** (n - p.g0 - p.k)
    slabs = min(x, BETA_TILE // (2**p.k * p.lanes)) if p.lanes == 2**p.g0 else 1
    return slabs, (x // slabs) * (2**p.g0 // p.lanes)


def beta_grad_split(d_ore, d_oim, ore, oim, lo_bit: int, nbits: int):
    """`beta_grad` by the ∂β kernel's decomposition: per group of
    `beta_grad_groups`, each amplitude's term of group qubit q,
    d_ore·oim' − d_oim·ore' in f32 (partner x ⊕ 2^(g0+q)), at leaf
    log2(lanes) + q of the kernel's pairwise tree of BETA_SLOTS leaves
    (zeros at the others); those values summed in f64 per row, over every
    group, and rounded once to f32. The f64 order is torch's, not the
    kernel's, so the two agree to the f64 rounding of the sum (almost
    always the same f32), not bit for bit."""
    b, dim = ore.shape
    n = dim.bit_length() - 1
    total = torch.zeros(b, dtype=torch.float64, device=ore.device)
    for g0, k, lanes in beta_grad_groups(lo_bit, nbits):
        shape = (b, 2 ** (n - g0 - k), 2**k, 2**g0)
        dr, di, o_re, o_im = (t.reshape(shape) for t in (d_ore, d_oim, ore, oim))

        def flip(t, q):
            return t.reshape(b, shape[1], 2 ** (k - q - 1), 2, 2**q, shape[3]).flip(3) \
                .reshape(shape)

        leaf0 = lanes.bit_length() - 1
        slots = [torch.zeros_like(dr)] * BETA_SLOTS
        for q in range(k):
            slots[leaf0 + q] = dr * flip(o_im, q) - di * flip(o_re, q)
        while len(slots) > 1:
            slots = [slots[i] + slots[i + 1] for i in range(0, len(slots), 2)]
        total += slots[0].to(torch.float64).sum(dim=(1, 2, 3))
    return total.to(torch.float32)
