"""∂β of the mixer in the layer backward: CUDA kernel and wrapper.

Per row b, over the qubits q of [lo_bit, lo_bit + nbits):

    ∂β[b] = Σ_x Σ_q ( d_ore[b, x]·oim[b, x ⊕ 2^q] − d_oim[b, x]·ore[b, x ⊕ 2^q] )

from the cotangents (d_ore, d_oim) of a mixer's output (ore, oim), four
(B, 2^n) f32 planes. The JAX package computes it as plain ``jnp`` inside
the ``custom_vjp`` of ``apply_layer`` and ``apply_mixer_bits``
(``repro/kernels/ops.py:291-321``, ``:417-424``), which XLA fuses; here it
is ``csrc/betagrad.cu``: one launch per read of the planes in
`ref.beta_grad_launches` (2 at n = 24: qubits 0-11 on contiguous tiles,
then 12-17 and 18-23 on runs of 64 lanes, fused so that the two groups'
tiles of each region share it through L2), each tile summing every
in-group pair product into one f64 partial, then a fixed-order sum of
each row's partials (no atomics, and a partial's place set by its tile
alone, so the result is bitwise repeatable and the same for a row alone
and in a batch). It writes no
neighbour-sum plane. The plain version is `ref.beta_grad` (neighbour-sum
planes and ``torch.sum``); `ref.beta_grad_split` mirrors the kernel's
decomposition on the CPU. No knob: the tile is the shared memory a CTA
stages.

Tolerance: ``BETA_GRAD_RTOL · S`` a row against the plain version, with
S = Σ_x Σ_q (|d_ore·oim'| + |d_oim·ore'|) (`tolerance`). The two sum the
same products in another order. The kernel rounds each term at most 6
times in f32 before its f64 sums (product, difference, a 16-leaf tree),
so it lies within 7·2⁻²⁴·S ≈ 4.2e-7·S of the exact sum; the rest of
1e-6·S is the plain version's own f32 rounding (24 neighbour adds, a
product and ``torch.sum``), whose worst case torch does not bound but
whose errors of random sign stay far below it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BETA_GRAD_RTOL = 1e-6  # of S = Σ_x Σ_q (|d_ore·oim'| + |d_oim·ore'|), per row


def tolerance(d_ore, d_oim, ore, oim, lo_bit: int, nbits: int) -> torch.Tensor:
    """(B,) ``BETA_GRAD_RTOL · S``, S from the plain version on |planes|:
    Σ|d_ore|·N(|oim|) + Σ|d_oim|·N(|ore|)."""
    s = ref.beta_grad(d_ore.abs(), -d_oim.abs(), ore.abs(), oim.abs(), lo_bit, nbits)
    return BETA_GRAD_RTOL * s


def beta_grad(d_ore: torch.Tensor, d_oim: torch.Tensor, ore: torch.Tensor,
              oim: torch.Tensor, lo_bit: int, nbits: int) -> torch.Tensor:
    """(B,) f32 ∂β over qubits [lo_bit, lo_bit + nbits) of (B, 2^n) planes;
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _build.on_cuda(ore):
        return ref.beta_grad(d_ore, d_oim, ore, oim, lo_bit, nbits)
    b, dim = ore.shape
    dev = ore.device
    n = dim.bit_length() - 1
    if dim != 2**n or lo_bit < 0 or nbits < 1 or lo_bit + nbits > n:
        raise ValueError(f"qubits [{lo_bit}, {lo_bit + nbits}) outside a state of "
                         f"width {dim}")
    for t, name in ((d_ore, "d_ore"), (d_oim, "d_oim"), (ore, "ore"), (oim, "oim")):
        _build.require(t, name, torch.float32, (b, dim), dev)
    launches = [[(p, *ref.beta_pass_tiles(n, p)) for p in launch]
                for launch in ref.beta_grad_launches(lo_bit, nbits)]
    parts = sum(row_parts for launch in launches for _, _, row_parts in launch)
    partial = torch.empty((b, parts), dtype=torch.float64, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    st = _build.stream(dev)
    part0 = 0
    for launch in launches:
        args = []
        for p, slabs, row_parts in launch:
            args += [p.g0, p.k, p.lanes, slabs, part0]
            part0 += row_parts
        args += [0] * (10 - len(args))  # no second group
        rc = _build.entry("beta_grad_pass")(
            d_ore.data_ptr(), d_oim.data_ptr(), ore.data_ptr(), oim.data_ptr(),
            partial.data_ptr(), b, n, parts, len(launch), *args, st)
        _build.check(rc, "beta_grad_pass")
    rc = _build.entry("beta_grad_final")(partial.data_ptr(), out.data_ptr(), b, parts, st)
    _build.check(rc, "beta_grad_final")
    _build.count_launch("beta_grad")
    return out
