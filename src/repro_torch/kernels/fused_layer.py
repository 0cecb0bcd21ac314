"""Fused cost phase + first mixer group: CUDA kernel and wrapper.

The counterpart of ``repro/kernels/fused_layer.py``: one pass applies
e^{-iγc} and then RX(2β)^{⊗k} on qubits 0..k-1 of the (B, R, 2^k) view,
with one (γ, β) per batch row. ``reverse=True`` mixes first and phases
second; called at (−γ, −β) it is the adjoint the layer backward runs.
The kernel is ``csrc/fused_layer.cu``; its plain version is
`fused_phase_mixer_group_plain` below. Its knob ``row_tile`` (rows of 2^k
per block, key ``fused_layer`` at the row's 2^n amplitudes) resolves
through `tuning.param`.
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
