"""Expectation of the diagonal objective: CUDA kernel and wrapper.

The counterpart of ``repro/kernels/phase.py::expectation``: Σ_x |ψ_x|²·c_x
per batch row, (B, 2^n) planes → (B,). The kernel is ``csrc/phase.cu``,
a deterministic two-pass reduction (no atomics); its plain version is
`ref.expectation`. The elementwise ``apply_phase`` kernel of the JAX
package is not ported: nothing on the solve path calls it (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

ELEMS_PER_BLOCK = 16384  # pass-1 chunk target; at most MAX_PARTS partials a row
MAX_PARTS = 1024


def num_parts(dim: int) -> int:
    """Pass-1 blocks per row: a power of two dividing ``dim``."""
    return max(1, min(MAX_PARTS, dim // ELEMS_PER_BLOCK))


def expectation(re: torch.Tensor, im: torch.Tensor,
                cutv: torch.Tensor) -> torch.Tensor:
    """⟨ψ|diag(c)|ψ⟩ per row: (B,) f32."""
    if not _build.on_cuda(re):
        return ref.expectation(re, im, cutv)
    b, dim = re.shape
    if dim & (dim - 1):
        raise ValueError(f"state width {dim} is not a power of two")
    dev = re.device
    for t, name in ((re, "re"), (im, "im"), (cutv, "cutv")):
        _build.require(t, name, torch.float32, (b, dim), dev)
    parts = num_parts(dim)
    partial = torch.empty((b, parts), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    rc = _build.entry("phase")(
        re.data_ptr(), im.data_ptr(), cutv.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, dim, parts, _build.stream(dev))
    _build.check(rc, "expectation")
    _build.count_launch("expectation")
    return out
