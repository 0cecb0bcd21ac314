"""Dispatch and autograd for the kernels on the solve path.

The counterpart of ``repro/kernels/ops.py``. Dispatch is by device: a CUDA
tensor launches the hand-written kernel, a CPU tensor takes the plain
version, and no path falls back from one to the other. Every state op is
batched, (B, 2^n) planes with one γ and one β per row.

The gradients mirror the JAX package's ``custom_vjp`` rules as
``torch.autograd.Function``s. The QAOA layer unitaries are their own
adjoints up to the sign of the angles, so each backward pass re-enters the
same kernels at negated angles:

- `apply_layer` (``_layer_vjp``, ops.py:407-451): the trailing mixer
  groups at −β in reverse order, then the fused kernel in ``reverse``
  mode at (−γ, −β); ∂β from the generator contraction over all n qubits
  of the layer output (`betagrad.beta_grad`, a kernel of its own: the JAX
  package leaves it to XLA), ∂γ from the phase rule on the layer input
  (`phase.phase_grad`, likewise).
- `apply_mixer_bits` (``_mixer_bits_vjp``, ops.py:302-330): the group at −β;
  ∂β over the group's qubits, as for the layer.
- `expectation` (``_expectation_vjp``, ops.py:467-486): closed form.
- `apply_mixer` (ops.py:333-340): the chain of `apply_mixer_bits` groups.
- `apply_phase` (``_phase_vjp``, ops.py:238-273): the same kernel at −γ
  on the cotangent, then ∂γ and ∂cutv in closed form.

`cutvals`, `cutvals_at` and `cut_batch_dense` are forward only: no path
differentiates them (as in the reference).

Every entry point records its dispatch in the build ledger
(`obs.ledger`, ``note_op``): ``cuda`` where its kernel launches, ``plain``
where a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, betagrad, cutbatch, fused_layer, mixer, phase
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
)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last `reset_launch_counts`."""
    return {name: _build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.reset_launches()


def _note(op: str, x) -> None:
    """One dispatch of ``op`` on ``x``'s device, in the build ledger."""
    get_ledger().note_op(op, "cuda" if x.is_cuda else "plain")


def cutvals(n: int, edges, weights, linear=None):
    """(B, 2^n) objective values; ``linear`` (B, n) adds per-vertex terms."""
    _note("cutvals", edges)
    return cutvals_mod.cutvals(n, edges, weights, linear)


def cutvals_at(idx, edges, weights, linear=None, *, n_bits=None):
    """(B·S, L) objective values of every edge row at the basis states of
    the (S, L) int32 table ``idx``; ``linear`` (B, n) adds per-vertex terms;
    ``n_bits``: every index lies below 2^n_bits (None reads idx.max())."""
    _note("cutvals_at", idx)
    return cutvals_mod.cutvals_at(idx, edges, weights, linear, n_bits=n_bits)


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

def _layer_dispatch(n, group, re, im, cutv, gamma, beta):
    """Phase + full mixer: the fused kernel for group 0, the strided kernel
    for every group above it."""
    b = re.shape[0]
    k = min(group, n)
    dk = 2**k
    re_m, im_m = fused_layer.fused_phase_mixer_group(
        re.reshape(b, -1, dk), im.reshape(b, -1, dk), cutv.reshape(b, -1, dk),
        gamma, beta, k)
    re, im = re_m.reshape(b, -1), im_m.reshape(b, -1)
    for g0 in range(k, n, group):
        re, im = mixer.apply_mixer_bits(re, im, n, g0, min(group, n - g0), beta)
    return re, im


def _layer_adjoint_dispatch(n, group, re, im, cutv, gamma, beta):
    """Transpose of `_layer_dispatch` on a cotangent: the trailing groups at
    −β in reverse order, then the fused kernel reversed at (−γ, −β)."""
    b = re.shape[0]
    k = min(group, n)
    dk = 2**k
    for g0 in reversed(range(k, n, group)):
        re, im = mixer.apply_mixer_bits(re, im, n, g0, min(group, n - g0),
                                        -beta)
    re_m, im_m = fused_layer.fused_phase_mixer_group(
        re.reshape(b, -1, dk), im.reshape(b, -1, dk), cutv.reshape(b, -1, dk),
        -gamma, -beta, k, reverse=True)
    return re_m.reshape(b, -1), im_m.reshape(b, -1)


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
        # the full n-qubit mixer acts last: ∂β contracts on the output
        d_beta = betagrad.beta_grad(d_ore, d_oim, ore, oim, 0, n)
        g_re, g_im = _layer_adjoint_dispatch(n, group, d_ore, d_oim, cutv,
                                             gamma, beta)
        # ∂γ and ∂cutv from the phase rule on the layer input; ∂γ through
        # `phase.phase_grad`, whose bits do not depend on the batch
        d_gamma = phase.phase_grad(re, im, g_re, g_im, cutv)
        d_cutv = (gamma[:, None] * (im * g_re - re * g_im)
                  if ctx.needs_input_grad[2] else None)
        return g_re, g_im, d_cutv, d_gamma, d_beta, None, None


def apply_layer(re, im, cutv, gamma, beta, n: int, group: int = 7):
    """One QAOA layer on (B, 2^n) planes: cost phase, then the n-qubit
    mixer; γ, β (B,). Differentiable in every tensor argument."""
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
