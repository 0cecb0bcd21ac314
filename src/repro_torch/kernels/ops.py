"""Dispatch and autograd for the kernels on the solve path.

The counterpart of ``repro/kernels/ops.py``. Dispatch is by device: a CUDA
tensor launches the hand-written kernel, a CPU tensor takes the plain
version, and no path falls back from one to the other. Every state op is
batched, (B, 2^n) planes with one γ and one β per row.

The gradients mirror the JAX package's ``custom_vjp`` rules as
``torch.autograd.Function``s. The QAOA layer unitaries are their own
adjoints up to the sign of the angles, so each backward pass re-enters the
same kernels at negated angles:

- `apply_layer` (``_layer_vjp``, ops.py:407-451): the strided mixer
  groups at −β in reverse order, then the fused kernel in ``reverse``
  mode at (−γ, −β); ∂β from the generator contraction over all n qubits,
  ∂γ from the phase rule on the layer input (the JAX package leaves both
  to XLA). On the card the reversed fused pass computes ∂γ and the ∂β of
  its own qubits at the mixer's input (`fused_layer.fused_layer_grads`),
  and `betagrad` the ∂β of the strided qubits on the layer output; on the
  CPU the plain versions take the whole of each (`ref.beta_grad`,
  `ref.phase_grad`).
- `apply_mixer_bits` (``_mixer_bits_vjp``, ops.py:302-330): the group at −β;
  ∂β over the group's qubits, as for the layer.
- `expectation` (``_expectation_vjp``, ops.py:467-486): closed form.
- `apply_mixer` (ops.py:333-340): the chain of `apply_mixer_bits` groups.
- `apply_phase` (``_phase_vjp``, ops.py:238-273): the same kernel at −γ
  on the cotangent, then ∂γ and ∂cutv in closed form.

- `cutvals` and `cutvals_at` (``_cutvals_bwd``, ``_cutvals_at_bwd``,
  ops.py:127-214): the objective is linear in the weights and the linear
  terms, so ∂w_e = Σ_x g[x]·xor_e(x) and ∂h_v = Σ_x g[x]·bit_v(x). The
  forward is the kernel; the backward is plain PyTorch (the reference
  leaves it to XLA), a slab of edges at a time, so that no (B, E, 2^n)
  tensor is built.

`cut_batch_dense` is forward only, as in the reference.

Every entry point records its dispatch in the build ledger
(`obs.ledger`, ``note_op``): ``cuda`` where its kernel launches, ``plain``
where a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, betagrad, cutbatch, fused_layer, mixer, phase, ref
from repro_torch.kernels import cutvals as cutvals_mod
from repro_torch.obs.ledger import get_ledger

# every kernel wrapper, by the name its launches are counted under
KERNELS = (
    "cutvals",
    "cutvals_at",
    "fused_phase_mixer_group",
    "mixer_group_strided",
    "mixer_group_trailing",
    "expectation",
    "apply_phase",
    "cut_batch_dense",
    "beta_grad",
    "phase_grad",
    "fused_layer_grads",  # reversed fused launches that wrote the gradients
    "mixer_strided_staged",  # strided launches that took the staged path
)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last `reset_launch_counts`."""
    return {name: _build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.reset_launches()


def set_aside_launches():
    """A context whose Counter holds, when it ends, the launches counted
    inside it, taken back out of the counts (a capture into a CUDA graph
    launches nothing)."""
    return _build.set_aside_launches()


def add_launches(counts) -> None:
    """Count launches made outside a wrapper's call (a graph's replay)."""
    _build.add_launches(counts)


def _note(op: str, x) -> None:
    """One dispatch of ``op`` on ``x``'s device, in the build ledger."""
    get_ledger().note_op(op, "cuda" if x.is_cuda else "plain")


# elements of one (B, edges, states) slab of the cutvals backward
GRAD_SLAB = 1 << 22


def _masked_sums(g, idx, lo, hi):
    """(B, m): Σ_x g[b, x]·(((idx[x] >> lo[b, j]) ^ (idx[x] >> hi[b, j])) & 1)
    for g (B, X) f32, idx (X,) int32 and lo, hi (B, m) int32, over slabs of
    the m columns so that no (B, m, X) tensor is built."""
    b, m = lo.shape
    out = torch.empty((b, m), dtype=torch.float32, device=g.device)
    step = max(1, GRAD_SLAB // max(1, b * idx.numel()))
    for c0 in range(0, m, step):
        i = lo[:, c0:c0 + step, None]
        j = hi[:, c0:c0 + step, None]
        crossed = ((idx >> i) ^ (idx >> j)) & 1
        out[:, c0:c0 + step] = (g[:, None, :] * crossed.to(torch.float32)).sum(-1)
    return out


def _cutvals_grads(ctx, idx, edges, g):
    """(∂weights (B, E), ∂linear (B, n_lin)) of Σ_x g[b, x]·c_b(idx[x]),
    each None where autograd does not ask for it (inputs 2 and 3 of both
    Functions): an edge row crosses where its endpoints' bits differ, a
    linear term counts where its bit is set (bit v XOR the virtual bit,
    always 0)."""
    d_w = d_lin = None
    if ctx.needs_input_grad[2]:
        d_w = _masked_sums(g, idx, edges[..., 0], edges[..., 1])
    if ctx.n_lin and ctx.needs_input_grad[3]:
        v = torch.arange(ctx.n_lin, dtype=torch.int32, device=g.device)
        v = v.expand(g.shape[0], ctx.n_lin)
        d_lin = _masked_sums(g, idx, v, torch.full_like(v, ref.VIRTUAL_BIT))
    return d_w, d_lin


class _Cutvals(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, edges, weights, linear):
        ctx.save_for_backward(edges)
        ctx.n, ctx.n_lin = n, 0 if linear is None else linear.shape[1]
        return cutvals_mod.cutvals(n, edges, weights, linear)

    @staticmethod
    def backward(ctx, g):
        (edges,) = ctx.saved_tensors
        idx = torch.arange(2**ctx.n, dtype=torch.int32, device=g.device)
        return None, None, *_cutvals_grads(ctx, idx, edges, g.contiguous())


class _CutvalsAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, edges, weights, linear, n_bits):
        ctx.save_for_backward(idx, edges)
        ctx.n_lin = 0 if linear is None else linear.shape[1]
        return cutvals_mod.cutvals_at(idx, edges, weights, linear, n_bits=n_bits)

    @staticmethod
    def backward(ctx, g):
        idx, edges = ctx.saved_tensors
        g = g.reshape(edges.shape[0], -1)  # row b·S + s → row b, states s·L + l
        return None, None, *_cutvals_grads(ctx, idx.reshape(-1), edges, g), None


def cutvals(n: int, edges, weights, linear=None):
    """(B, 2^n) objective values; ``linear`` (B, n) adds per-vertex terms.
    Differentiable in ``weights`` and ``linear``."""
    _note("cutvals", edges)
    return _Cutvals.apply(n, edges, weights, linear)


def cutvals_at(idx, edges, weights, linear=None, *, n_bits=None):
    """(B·S, L) objective values of every edge row at the basis states of
    the (S, L) int32 table ``idx``; ``linear`` (B, n) adds per-vertex terms;
    ``n_bits``: every index lies below 2^n_bits (None reads idx.max()).
    Differentiable in ``weights`` and ``linear``."""
    _note("cutvals_at", idx)
    return _CutvalsAt.apply(idx, edges, weights, linear, n_bits)


def cut_batch_dense(spins, adjacency, total_weight):
    """(B,) cut values of ±1 spin rows (B, V) through the dense (V, V)
    adjacency; forward only."""
    _note("cut_batch_dense", spins)
    return cutbatch.cut_batch_dense(spins, adjacency, total_weight)


# ---------------------------------------------------------------------------
# the cost phase: its transpose is the same rotation at −γ
# ---------------------------------------------------------------------------

class _Phase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, cutv, gamma):
        ctx.save_for_backward(re, im, cutv, gamma)
        return phase.apply_phase(re, im, cutv, gamma)

    @staticmethod
    def backward(ctx, d_ore, d_oim):
        re, im, cutv, gamma = ctx.saved_tensors
        g_re, g_im = phase.apply_phase(d_ore.contiguous(), d_oim.contiguous(),
                                       cutv, -gamma)
        d_gamma = phase.phase_grad(re, im, g_re, g_im, cutv)
        d_cutv = (gamma[:, None] * (im * g_re - re * g_im)
                  if ctx.needs_input_grad[2] else None)
        return g_re, g_im, d_cutv, d_gamma


def apply_phase(re, im, cutv, gamma):
    """e^{-iγc}ψ on (B, 2^n) planes, γ (B,); differentiable in every
    argument."""
    _note("apply_phase", re)
    return _Phase.apply(re, im, cutv, gamma)


# ---------------------------------------------------------------------------
# the layer and its adjoint
# ---------------------------------------------------------------------------

# qubits the fused pass can take: its tile holds TILE_AMPS amplitudes
FUSED_MAX_K = fused_layer.TILE_AMPS.bit_length() - 1


def layer_passes(n: int, group: int, widest: int = FUSED_MAX_K):
    """The passes of one layer's mixer over (B, 2^n) planes: ``(f,
    groups)``, the fused phase-and-mixer pass on qubits [0, f), then the
    strided groups ``(lo_bit, nbits)`` above it. The fewest passes the
    widths allow: s = ⌈max(0, n − widest) / group⌉ strided groups of at
    most ``group`` qubits, and the fused pass on every qubit below them
    (at least min(n, group), so a count of passes that cannot be cut
    keeps the split of ``group`` qubits a pass). ``widest`` = ``group``
    is that split, the reference's."""
    s = -(-max(0, n - widest) // group)
    f = max(min(n, group), n - s * group)
    return f, tuple((g0, min(group, n - g0)) for g0 in range(f, n, group))


def passes_on(x, n: int, group: int) -> tuple[int, tuple[tuple[int, int], ...]]:
    """The passes a layer runs on ``x``'s device: `layer_passes` on a CUDA
    tensor, whose fused pass takes up to FUSED_MAX_K qubits; elsewhere the
    reference's split (the plain versions build each pass's 2^k × 2^k
    matrices)."""
    return layer_passes(n, group, FUSED_MAX_K if _build.on_cuda(x) else group)


def _layer_dispatch(n, group, re, im, cutv, gamma, beta):
    """Phase + full mixer: the fused kernel on the low qubits, the strided
    kernel for every group above them (`passes_on`)."""
    b = re.shape[0]
    k, groups = passes_on(re, n, group)
    dk = 2**k
    re_m, im_m = fused_layer.fused_phase_mixer_group(
        re.reshape(b, -1, dk), im.reshape(b, -1, dk), cutv.reshape(b, -1, dk),
        gamma, beta, k)
    re, im = re_m.reshape(b, -1), im_m.reshape(b, -1)
    for g0, nbits in groups:
        re, im = mixer.apply_mixer_bits(re, im, n, g0, nbits, beta)
    return re, im


def _layer_adjoint_dispatch(n, group, re, im, cutv, gamma, beta):
    """Transpose of `_layer_dispatch` on a cotangent: the strided groups at
    −β in reverse order, then the fused kernel reversed at (−γ, −β)."""
    b = re.shape[0]
    k, groups = passes_on(re, n, group)
    dk = 2**k
    for g0, nbits in reversed(groups):
        re, im = mixer.apply_mixer_bits(re, im, n, g0, nbits, -beta)
    re_m, im_m = fused_layer.fused_phase_mixer_group(
        re.reshape(b, -1, dk), im.reshape(b, -1, dk), cutv.reshape(b, -1, dk),
        -gamma, -beta, k, reverse=True)
    return re_m.reshape(b, -1), im_m.reshape(b, -1)


def _layer_backward_on_card(n: int, group: int, d_ore, d_oim, re, im, ore, oim,
                            cutv, gamma, beta):
    """(g_re, g_im, ∂γ, ∂β) of one layer on the card. ∂β of the strided
    qubits [f, n) on the layer output (`betagrad`), the strided groups at
    −β in reverse order, then the reversed fused pass with the gradients:
    ∂γ, and ∂β of qubits [0, f) at the mixer's input. Its ∂β partials head
    the row that `betagrad`'s follow, so each row sums in one fixed order."""
    b = re.shape[0]
    k, groups = passes_on(re, n, group)
    view = (b, -1, 2**k)
    tiles = fused_layer.grad_tiles(2 ** (n - k), k, re.device)
    strided = betagrad.parts_per_row(n, k, n - k) if k < n else 0
    beta_part = torch.empty((b, tiles + strided), dtype=torch.float64, device=re.device)
    gamma_part = torch.empty((b, tiles), dtype=torch.float64, device=re.device)
    if k < n:
        betagrad.beta_grad_partials(d_ore, d_oim, ore, oim, k, n - k, beta_part, tiles)
    for g0, nbits in reversed(groups):
        d_ore, d_oim = mixer.apply_mixer_bits(d_ore, d_oim, n, g0, nbits, -beta)
    g_re, g_im = fused_layer.fused_layer_grads(
        d_ore.reshape(view), d_oim.reshape(view), cutv.reshape(view), -gamma, -beta, k,
        re.reshape(view), im.reshape(view), beta_part, gamma_part)
    return (g_re.reshape(b, -1), g_im.reshape(b, -1), betagrad.final_sum(gamma_part),
            betagrad.final_sum(beta_part))


class _Layer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, cutv, gamma, beta, n, group):
        ore, oim = _layer_dispatch(n, group, re, im, cutv, gamma, beta)
        # the inputs are the previous layer's outputs: saved, never cloned
        ctx.save_for_backward(re, im, cutv, gamma, beta, ore, oim)
        ctx.n, ctx.group = n, group
        return ore, oim

    @staticmethod
    def backward(ctx, d_ore, d_oim):
        re, im, cutv, gamma, beta, ore, oim = ctx.saved_tensors
        n, group = ctx.n, ctx.group
        # a cotangent may arrive strided (``out.sum()`` gives an expanded one)
        d_ore, d_oim = d_ore.contiguous(), d_oim.contiguous()
        if _build.on_cuda(re):
            g_re, g_im, d_gamma, d_beta = _layer_backward_on_card(
                n, group, d_ore, d_oim, re, im, ore, oim, cutv, gamma, beta)
        else:
            # the full n-qubit mixer acts last: ∂β contracts on the output
            d_beta = betagrad.beta_grad(d_ore, d_oim, ore, oim, 0, n)
            g_re, g_im = _layer_adjoint_dispatch(n, group, d_ore, d_oim, cutv,
                                                 gamma, beta)
            # ∂γ from the phase rule on the layer input
            d_gamma = phase.phase_grad(re, im, g_re, g_im, cutv)
        # ∂cutv from the phase rule on the layer input
        d_cutv = (gamma[:, None] * (im * g_re - re * g_im)
                  if ctx.needs_input_grad[2] else None)
        return g_re, g_im, d_cutv, d_gamma, d_beta, None, None


def apply_layer(re, im, cutv, gamma, beta, n: int, group: int = 7):
    """One QAOA layer on (B, 2^n) planes: cost phase, then the n-qubit
    mixer, in the passes of `layer_passes` on the card; γ, β (B,).
    Differentiable in every tensor argument."""
    _note("apply_layer", re)
    return _Layer.apply(re, im, cutv, gamma, beta, n, group)


class _MixerBits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, beta, n, lo_bit, nbits):
        ore, oim = mixer.apply_mixer_bits(re, im, n, lo_bit, nbits, beta)
        ctx.save_for_backward(ore, oim, beta)
        ctx.geom = (n, lo_bit, nbits)
        return ore, oim

    @staticmethod
    def backward(ctx, d_ore, d_oim):
        ore, oim, beta = ctx.saved_tensors
        n, lo_bit, nbits = ctx.geom
        d_ore, d_oim = d_ore.contiguous(), d_oim.contiguous()
        g_re, g_im = mixer.apply_mixer_bits(d_ore, d_oim, n, lo_bit, nbits,
                                            -beta)
        d_beta = betagrad.beta_grad(d_ore, d_oim, ore, oim, lo_bit, nbits)
        return g_re, g_im, d_beta, None, None, None


def apply_mixer_bits(re, im, n: int, lo_bit: int, nbits: int, beta):
    """RX(2β)^{⊗nbits} on qubits [lo_bit, lo_bit + nbits), differentiable."""
    _note("apply_mixer_bits", re)
    return _MixerBits.apply(re, im, beta, n, lo_bit, nbits)


def apply_mixer(re, im, n: int, beta, group: int = 7):
    """The full n-qubit mixer as a chain of differentiable groups: the
    trailing kernel for qubits 0..group-1, the strided one above them."""
    _note("apply_mixer", re)
    for g0 in range(0, n, group):
        re, im = apply_mixer_bits(re, im, n, g0, min(group, n - g0), beta)
    return re, im


class _Expectation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, cutv):
        ctx.save_for_backward(re, im, cutv)
        return phase.expectation(re, im, cutv)

    @staticmethod
    def backward(ctx, g):
        re, im, cutv = ctx.saved_tensors
        g = g[:, None]
        d_cutv = g * (re * re + im * im) if ctx.needs_input_grad[2] else None
        return 2.0 * g * re * cutv, 2.0 * g * im * cutv, d_cutv


def expectation(re, im, cutv):
    """Σ|ψ|²·c per row, (B,); differentiable in every argument."""
    _note("expectation", re)
    return _Expectation.apply(re, im, cutv)
