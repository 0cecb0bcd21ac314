"""Fused cost phase + first mixer group: CUDA kernel and wrapper.

The counterpart of ``repro/kernels/fused_layer.py``: one pass applies
e^{-iγc} and then RX(2β)^{⊗k} on qubits 0..k-1 of the (B, R, 2^k) view,
with one (γ, β) per batch row. ``reverse=True`` mixes first and phases
second; called at (−γ, −β) it is the adjoint the layer backward runs.
The kernel is ``csrc/fused_layer.cu``; its plain version is
`fused_phase_mixer_group_plain` below. Its knob ``row_tile`` (rows of 2^k
per block, key ``fused_layer`` at the row's 2^n amplitudes) resolves
through `tuning.param`.

`fused_layer_grads` is the reversed pass of the layer backward with the
layer's gradients: besides the cotangent it reads the layer's input and
writes a tile's f64 partials of ∂γ and of ∂β over its k qubits (ops.py's
`_Layer.backward` sums them). Its plain mirror is `ref.layer_grads_split`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning

TILE_AMPS = 4096  # amplitudes a block holds in shared memory (kTile in common.cuh)


def row_tile(op: str, r: int, k: int, device, dim: int = 0) -> int:
    """Rows of 2^k per block for the row-tiled kernels (``fused_layer``,
    ``mixer_matmul``): TILE_AMPS >> k clamped to R with tuning off; a
    tuned value, looked up under ``dim`` (R if 0), must keep the tile
    within TILE_AMPS amplitudes."""
    want = tuning.param(op, dim or r, "row_tile", TILE_AMPS >> k, device)
    if not tuning.is_pow2(want) or want << k > TILE_AMPS:
        raise ValueError(f"{op} row_tile {want} outside the kernel's range: "
                         f"a power of two with row_tile * 2^{k} <= {TILE_AMPS}")
    return tuning.clamp_tile(r, want)


def fused_phase_mixer_group_plain(re, im, cutv, gamma, beta, k: int,
                                  reverse: bool = False):
    """Plain version: `ref.apply_phase` and the dense group product."""
    b, r, dk = re.shape
    shape = (b, r, dk, 1)

    def mixer(x, y):
        ox, oy = ref.mixer_group(x.reshape(shape), y.reshape(shape), beta, k)
        return ox.reshape(b, r, dk), oy.reshape(b, r, dk)

    if reverse:
        return ref.apply_phase(*mixer(re, im), cutv, gamma)
    return mixer(*ref.apply_phase(re, im, cutv, gamma))


def fused_phase_mixer_group(re: torch.Tensor, im: torch.Tensor,
                            cutv: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, k: int, *,
                            reverse: bool = False):
    """(B, R, 2^k) planes and cut values, γ and β (B,) → one fused pass."""
    if not _build.on_cuda(re):
        return fused_phase_mixer_group_plain(re, im, cutv, gamma, beta, k,
                                             reverse)
    b, r, dk = re.shape
    if dk != 2**k or not 1 <= k or dk > TILE_AMPS or r & (r - 1):
        raise ValueError(f"bad fused view {tuple(re.shape)} for k={k}")
    dev = re.device
    for t, name in ((re, "re"), (im, "im"), (cutv, "cutv")):
        _build.require(t, name, torch.float32, (b, r, dk), dev)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    _build.require(gamma, "gamma", torch.float32, (b,), dev)
    _build.require(beta, "beta", torch.float32, (b,), dev)
    # keyed on a row's 2^n amplitudes: the pass plan takes k from n, so
    # one entry holds the row_tile of one k (R alone runs at several)
    tile_rows = row_tile("fused_layer", r, k, dev, dim=r << k)
    ore = torch.empty_like(re)
    oim = torch.empty_like(im)
    rc = _build.entry("fused_layer")(
        re.data_ptr(), im.data_ptr(), cutv.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), ore.data_ptr(), oim.data_ptr(), b, r, k,
        int(reverse), tile_rows, _build.stream(dev))
    _build.check(rc, "fused_phase_mixer_group")
    _build.count_launch("fused_phase_mixer_group")
    return ore, oim


def grad_tiles(r: int, k: int, device) -> int:
    """Tiles a row of the (B, R, 2^k) view, one partial of each gradient
    each: R over the fused pass's ``row_tile``."""
    return r // row_tile("fused_layer", r, k, device, dim=r << k)


def fused_layer_grads(d_re: torch.Tensor, d_im: torch.Tensor, cutv: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, k: int,
                      re: torch.Tensor, im: torch.Tensor, beta_part: torch.Tensor,
                      gamma_part: torch.Tensor):
    """The reversed pass on the cotangent (B, R, 2^k) at the pass's angles
    (the layer's −γ, −β), as `fused_phase_mixer_group` with ``reverse``,
    beside the layer's input ``re``, ``im``: returns the pulled-back
    cotangent and writes tile t's ∂β over qubits [0, k), at the mixer's
    input, to ``beta_part[:, t]`` and its ∂γ to ``gamma_part[:, t]`` (f64;
    `grad_tiles` of each, ``beta_part`` may have more columns). CUDA
    tensors only: on the CPU the layer backward keeps its plain path."""
    b, r, dk = d_re.shape
    if dk != 2**k or not 1 <= k or dk > TILE_AMPS or r & (r - 1):
        raise ValueError(f"bad fused view {tuple(d_re.shape)} for k={k}")
    dev = d_re.device
    for t, name in ((d_re, "d_re"), (d_im, "d_im"), (cutv, "cutv"), (re, "re"),
                    (im, "im")):
        _build.require(t, name, torch.float32, (b, r, dk), dev)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    _build.require(gamma, "gamma", torch.float32, (b,), dev)
    _build.require(beta, "beta", torch.float32, (b,), dev)
    tile_rows = row_tile("fused_layer", r, k, dev, dim=r << k)
    tiles = r // tile_rows
    _build.require(gamma_part, "gamma_part", torch.float64, (b, tiles), dev)
    parts = beta_part.shape[1]
    _build.require(beta_part, "beta_part", torch.float64, (b, parts), dev)
    if parts < tiles:
        raise ValueError(f"beta_part has {parts} columns for {tiles} tiles a row")
    ore = torch.empty_like(d_re)
    oim = torch.empty_like(d_im)
    rc = _build.entry("fused_layer_grads")(
        d_re.data_ptr(), d_im.data_ptr(), cutv.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), re.data_ptr(), im.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), beta_part.data_ptr(), gamma_part.data_ptr(), parts, b, r,
        k, tile_rows, _build.stream(dev))
    _build.check(rc, "fused_layer_grads")
    _build.count_launch("fused_phase_mixer_group")
    _build.count_launch("fused_layer_grads")
    return ore, oim
