"""Input shape cells: the assigned (architecture × input-shape) grid (port
of the JAX package's ``launch/specs.py``).

`input_specs(cell)` returns stand-ins for every input of the step the
dry-run traces: tensors on the ``meta`` device, which carry a shape and a
dtype and allocate nothing. `step_kind` tells the dry-run which program to
trace: the train step for ``train_*``, prefill for ``prefill_*``, a decode
step for ``decode_*`` / ``long_*``.

Skip policy: long_500k runs only for sub-quadratic archs (ssm / hybrid /
gemma3's 5:1 local:global); pure full-attention archs skip it. Every skip
is an explicit `SkipCell` with its reason string.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}

# archs allowed to run long_500k (sub-quadratic decode paths)
LONG_OK = {"mamba2_1_3b", "zamba2_2_7b", "gemma3_4b", "gemma3_27b"}

LONG_SKIP_REASON = (
    "pure full-attention decode at 524k context is "
    "quadratic-cost/cache-infeasible by design; run only "
    "for SSM/hybrid/5:1-local archs (DESIGN.md §4)"
)


@dataclasses.dataclass(frozen=True)
class SkipCell:
    arch: str
    shape: str
    reason: str


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int
    cfg: ModelConfig


def all_cells():
    """The 40-cell grid; skipped cells appear as SkipCell records."""
    out = []
    for arch in configs.lm_arch_ids():
        cfg = configs.get_config(arch)
        for shape, meta in SHAPES.items():
            if shape == "long_500k" and arch not in LONG_OK:
                out.append(SkipCell(arch, shape, LONG_SKIP_REASON))
                continue
            out.append(Cell(arch, shape, meta["kind"], meta["seq"], meta["batch"], cfg))
    return out


def get_cell(arch: str, shape: str) -> Cell:
    arch = configs.canonical(arch)
    meta = SHAPES[shape]
    return Cell(arch, shape, meta["kind"], meta["seq"], meta["batch"],
                configs.get_config(arch))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cell: Cell) -> dict:
    """Abstract data inputs (meta tensors) for the cell's step function."""
    cfg = cell.cfg
    b, s = cell.batch, cell.seq
    if cell.kind in ("train", "prefill"):
        text = s - (cfg.frontend_seq if cfg.family == "vlm" else 0)
        specs = {"tokens": _sds((b, text), torch.int32)}
        if cell.kind == "train":
            specs["labels"] = _sds((b, text), torch.int32)
        if cfg.family == "vlm":
            specs["patches"] = _sds((b, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            specs["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        return specs
    if cell.kind == "decode":
        return {"token": _sds((b,), torch.int32)}
    raise ValueError(cell.kind)


def decode_state_specs_abstract(cell: Cell):
    """The cell's `DecodeState` (cache sized to the cell's seq) built on the
    ``meta`` device: shapes and dtypes, nothing allocated."""
    from repro_torch.models import decode as D

    return D.init_decode_state(cell.cfg, cell.batch, cell.seq, device="meta")
