"""Transverse-field mixer groups: the CUDA kernels and their wrappers.

The counterpart of ``repro/kernels/mixer.py``, with one β per batch row.
``mixer_group_strided`` applies RX(2β)^{⊗k} to the middle axis of a
(B, X, 2^k, Y) view (the Pallas ``_mixer_strided_kernel``); its kernel is
``csrc/mixer.cu``. ``mixer_group_trailing`` applies it to the trailing
axis of a (B, R, 2^k) view (``_mixer_kernel``, launched by
``mixer_group_matmul``); its kernel is the phase-free instance of
``csrc/fused_layer.cu``. Their plain versions are `ref.mixer_group` and
`mixer_group_trailing_plain`. `apply_mixer_bits_relayout` is the path the
strided kernel replaced (permute the group to the trailing axis, run the
trailing kernel, permute back), kept as the sweep's yardstick.

Knobs (through `tuning.param`): ``tile_y``, lanes along Y per strided
block (key ``mixer_strided``); ``row_tile`` for the trailing kernel (key
``mixer_matmul``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning
from repro_torch.kernels.fused_layer import TILE_AMPS, row_tile
from repro_torch.kernels.ref import popcount


def tile_y(x: int, y: int, k: int, device) -> int:
    """Lanes along Y per strided block: TILE_AMPS >> k clamped to Y with
    tuning off; a tuned value must keep 2^k * tile_y within TILE_AMPS."""
    want = tuning.param("mixer_strided", x * y, "tile_y", TILE_AMPS >> k, device)
    if not tuning.is_pow2(want) or want << k > TILE_AMPS:
        raise ValueError(f"mixer_strided tile_y {want} outside the kernel's "
                         f"range: a power of two with 2^{k} * tile_y <= {TILE_AMPS}")
    return tuning.clamp_tile(y, want)


def rx_group_mats(beta: torch.Tensor, k: int):
    """(C, D), each (B, 2^k, 2^k): Re and Im of the RX-group unitary per row.

    The generator form of ``repro/kernels/mixer.py::rx_group_mats``:
    integer powers as ``pow`` on magnitudes plus sign bookkeeping, exact
    for negative bases. Both matrices are symmetric; C is even in β and D
    odd, so the group's adjoint is the same generator at −β. The CUDA
    kernels never build these matrices (they apply k butterflies); the
    tests hold this form against `ref.rx_kron_parts`.
    """
    dk = 2**k
    a = torch.arange(dk, dtype=torch.int32, device=beta.device)
    d = popcount(a[:, None] ^ a[None, :])
    dd = d.to(torch.float32)
    kk = torch.tensor(float(k), dtype=torch.float32, device=beta.device)
    cb = torch.cos(beta)[:, None, None]
    sb = torch.sin(beta)[:, None, None]
    neg1 = torch.tensor(-1.0, dtype=torch.float32, device=beta.device)
    mag = (
        torch.pow(cb.abs(), kk - dd)
        * torch.pow(sb.abs(), dd)
        * torch.where(cb < 0, torch.pow(neg1, kk - dd), 1.0)
        * torch.where(sb < 0, torch.pow(neg1, dd), 1.0)
    )
    m4 = d % 4
    cmat = mag * torch.where(m4 == 0, 1.0, torch.where(m4 == 2, -1.0, 0.0))
    dmat = mag * torch.where(m4 == 1, -1.0, torch.where(m4 == 3, 1.0, 0.0))
    return cmat, dmat


def mixer_group_strided(re3: torch.Tensor, im3: torch.Tensor,
                        beta: torch.Tensor, k: int):
    """RX(2β)^{⊗k} on the middle axis of (B, X, 2^k, Y) planes, β (B,)."""
    if not _build.on_cuda(re3):
        return ref.mixer_group(re3, im3, beta, k)
    b, x, dk, y = re3.shape
    if dk != 2**k or not 1 <= k <= 12 or y & (y - 1):
        raise ValueError(f"bad mixer view {tuple(re3.shape)} for k={k}")
    dev = re3.device
    for t, name in ((re3, "re"), (im3, "im")):
        _build.require(t, name, torch.float32, (b, x, dk, y), dev)
    beta = beta.to(torch.float32).contiguous()
    _build.require(beta, "beta", torch.float32, (b,), dev)
    ty = tile_y(x, y, k, dev)
    ore = torch.empty_like(re3)
    oim = torch.empty_like(im3)
    rc = _build.entry("mixer")(
        re3.data_ptr(), im3.data_ptr(), beta.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), b, x, k, y, ty, _build.stream(dev))
    _build.check(rc, "mixer_group_strided")
    _build.count_launch("mixer_group_strided")
    return ore, oim


def mixer_group_trailing_plain(re3, im3, beta, k: int):
    """Plain version: `ref.mixer_group` with the group as the last axis."""
    b, r, dk = re3.shape
    ore, oim = ref.mixer_group(re3.reshape(b, r, dk, 1), im3.reshape(b, r, dk, 1),
                               beta, k)
    return ore.view(b, r, dk), oim.view(b, r, dk)


def mixer_group_trailing(re3: torch.Tensor, im3: torch.Tensor,
                         beta: torch.Tensor, k: int):
    """RX(2β)^{⊗k} on the trailing axis of (B, R, 2^k) planes, β (B,)."""
    if not _build.on_cuda(re3):
        return mixer_group_trailing_plain(re3, im3, beta, k)
    b, r, dk = re3.shape
    if dk != 2**k or not 1 <= k <= 12 or r & (r - 1):
        raise ValueError(f"bad trailing mixer view {tuple(re3.shape)} for k={k}")
    dev = re3.device
    for t, name in ((re3, "re"), (im3, "im")):
        _build.require(t, name, torch.float32, (b, r, dk), dev)
    beta = beta.to(torch.float32).contiguous()
    _build.require(beta, "beta", torch.float32, (b,), dev)
    tile_rows = row_tile("mixer_matmul", r, k, dev)
    ore = torch.empty_like(re3)
    oim = torch.empty_like(im3)
    rc = _build.entry("mixer_trailing")(
        re3.data_ptr(), im3.data_ptr(), beta.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), b, r, k, tile_rows, _build.stream(dev))
    _build.check(rc, "mixer_group_trailing")
    _build.count_launch("mixer_group_trailing")
    return ore, oim


def apply_mixer_bits(re: torch.Tensor, im: torch.Tensor, n: int, lo_bit: int,
                     nbits: int, beta: torch.Tensor):
    """RX(2β)^{⊗nbits} on qubits [lo_bit, lo_bit + nbits) of (B, 2^n) planes.

    ``lo_bit == 0`` runs the trailing-axis kernel on the (B, R, 2^nbits)
    view, ``lo_bit > 0`` the strided kernel on the (B, X, 2^nbits, Y) view
    (both metadata-only reshapes).
    """
    b = re.shape[0]
    if lo_bit == 0:
        shape = (b, 2 ** (n - nbits), 2**nbits)
        ore, oim = mixer_group_trailing(re.reshape(shape), im.reshape(shape),
                                        beta, nbits)
    else:
        shape = (b, 2 ** (n - lo_bit - nbits), 2**nbits, 2**lo_bit)
        ore, oim = mixer_group_strided(re.reshape(shape), im.reshape(shape),
                                       beta, nbits)
    return ore.reshape(b, -1), oim.reshape(b, -1)


def apply_mixer_bits_relayout(re: torch.Tensor, im: torch.Tensor, n: int,
                              lo_bit: int, nbits: int, beta: torch.Tensor):
    """`apply_mixer_bits` by relayout: permute the group to the trailing
    axis, run the trailing kernel on (B, X·Y, 2^nbits), permute back (two
    extra copies of both planes). The yardstick the strided kernel is
    measured against; the same unitary."""
    b = re.shape[0]
    x, dk, y = 2 ** (n - lo_bit - nbits), 2**nbits, 2**lo_bit
    if y == 1:
        return apply_mixer_bits(re, im, n, lo_bit, nbits, beta)

    def to_trailing(t):
        return t.view(b, x, dk, y).transpose(2, 3).reshape(b, x * y, dk)

    ore, oim = mixer_group_trailing(to_trailing(re), to_trailing(im), beta, nbits)

    def back(t):
        return t.view(b, x, y, dk).transpose(2, 3).reshape(b, -1)

    return back(ore), back(oim)
