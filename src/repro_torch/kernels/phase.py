"""The diagonal cost layer and its expectation: CUDA kernels and wrappers.

The counterpart of ``repro/kernels/phase.py``, batched over (B, 2^n)
planes. `apply_phase` is e^{-iγc}ψ with one γ per row (the Pallas
``_phase_kernel``); `expectation` is Σ_x |ψ_x|²·c_x per row, (B,) (the
Pallas ``_exp_kernel``), a deterministic two-pass reduction with no
atomics. `phase_grad` is the phase rule's ∂γ, Σ_x c_x·(im_x·ḡre_x −
re_x·ḡim_x) per row, in the same two passes, so its bits do not depend on
the rows it is batched with (the JAX package leaves it to XLA). The
kernels are ``csrc/phase.cu``; their plain versions are `ref.apply_phase`,
`ref.expectation` and `ref.phase_grad`.

Launch geometry resolves through `tuning.param`; with tuning off (the
default) it is the built-in one below.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

TILE = 4096  # apply_phase: amplitudes per block
ELEMS_PER_BLOCK = 16384  # expectation: pass-1 chunk target
MAX_PARTS = 1024  # expectation: at most this many partials a row by default
MIN_TILE = 256  # both: at least one amplitude per thread of a block


def default_expectation_tile(dim: int) -> int:
    """Amplitudes per pass-1 block with tuning off: ELEMS_PER_BLOCK, or
    more where a row would otherwise need over MAX_PARTS partials."""
    return max(ELEMS_PER_BLOCK, dim // MAX_PARTS)


def _tile(op: str, dim: int, default: int, device) -> int:
    """The knob ``tile`` of ``op`` for a row of ``dim`` amplitudes: a power
    of two, clamped to the row, at least MIN_TILE (or the whole row)."""
    if dim & (dim - 1):
        raise ValueError(f"state width {dim} is not a power of two")
    want = tuning.param(op, dim, "tile", default, device)
    if not tuning.is_pow2(want):
        raise ValueError(f"{op} tile {want} is not a power of two")
    tile = tuning.clamp_tile(dim, want)
    if tile < min(MIN_TILE, dim):
        raise ValueError(f"{op} tile {want} below {MIN_TILE} amplitudes")
    return tile


def apply_phase(re: torch.Tensor, im: torch.Tensor, cutv: torch.Tensor,
                gamma: torch.Tensor):
    """(re, im) ← e^{-iγc}(re, im) on (B, 2^n) planes, γ (B,)."""
    if not _build.on_cuda(re):
        return ref.apply_phase(re, im, cutv, gamma)
    b, dim = re.shape
    dev = re.device
    tile = _tile("apply_phase", dim, TILE, dev)
    for t, name in ((re, "re"), (im, "im"), (cutv, "cutv")):
        _build.require(t, name, torch.float32, (b, dim), dev)
    gamma = gamma.to(torch.float32).contiguous()
    _build.require(gamma, "gamma", torch.float32, (b,), dev)
    ore = torch.empty_like(re)
    oim = torch.empty_like(im)
    rc = _build.entry("apply_phase")(
        re.data_ptr(), im.data_ptr(), cutv.data_ptr(), gamma.data_ptr(),
        ore.data_ptr(), oim.data_ptr(), b, dim, tile, _build.stream(dev))
    _build.check(rc, "apply_phase")
    _build.count_launch("apply_phase")
    return ore, oim


def expectation(re: torch.Tensor, im: torch.Tensor,
                cutv: torch.Tensor) -> torch.Tensor:
    """⟨ψ|diag(c)|ψ⟩ per row: (B,) f32."""
    if not _build.on_cuda(re):
        return ref.expectation(re, im, cutv)
    b, dim = re.shape
    dev = re.device
    tile = _tile("expectation", dim, default_expectation_tile(dim), dev)
    for t, name in ((re, "re"), (im, "im"), (cutv, "cutv")):
        _build.require(t, name, torch.float32, (b, dim), dev)
    parts = dim // tile
    partial = torch.empty((b, parts), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.entry("expectation")(
        re.data_ptr(), im.data_ptr(), cutv.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, dim, parts, _build.stream(dev))
    _build.check(rc, "expectation")
    _build.count_launch("expectation")
    return out


def phase_grad(re: torch.Tensor, im: torch.Tensor, g_re: torch.Tensor,
               g_im: torch.Tensor, cutv: torch.Tensor) -> torch.Tensor:
    """∂γ of the phase rule: Σ_x c_x·(im_x·g_re,x − re_x·g_im,x) per row,
    (B,) f32, on (B, 2^n) planes; the expectation's geometry."""
    if not _build.on_cuda(re):
        return ref.phase_grad(re, im, g_re, g_im, cutv)
    b, dim = re.shape
    dev = re.device
    tile = _tile("expectation", dim, default_expectation_tile(dim), dev)
    for t, name in ((re, "re"), (im, "im"), (g_re, "g_re"), (g_im, "g_im"),
                    (cutv, "cutv")):
        _build.require(t, name, torch.float32, (b, dim), dev)
    parts = dim // tile
    partial = torch.empty((b, parts), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.entry("phase_grad")(
        re.data_ptr(), im.data_ptr(), g_re.data_ptr(), g_im.data_ptr(),
        cutv.data_ptr(), partial.data_ptr(), out.data_ptr(), b, dim, parts,
        _build.stream(dev))
    _build.check(rc, "phase_grad")
    _build.count_launch("phase_grad")
    return out
