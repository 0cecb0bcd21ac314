"""Per-kernel roofline bound on the H100 (port of the kernel half of
``repro/roofline/analysis.py``: ``KERNEL_PEAKS``, ``kernel_bound_s``,
``achieved_fraction``).

The least time a card could take for one launch is the larger of the
operations over the card's peak rate for their type and the bytes the
launch must move (each input read once, each output written once) over
its memory rate. Two operation types occur: f32 on the CUDA cores (every
state kernel and the cut tables; no TF32) and bf16 products with f32
accumulation on the tensor cores (``cut_batch_dense``, unit
``"bf16_tensor"``). The rows are NVIDIA's data-sheet figures, dense, at
the full power limit; a card set below it runs slower, which is why every
measurement keeps the card's power limit beside it.

The HLO roofline of the reference (compiled dry-run artifacts) has no
counterpart yet: it waits for the LM slice (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

# card → (f32 FLOP/s on the CUDA cores, memory bytes/s)
KERNEL_PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
}
# card → bf16 FLOP/s on the tensor cores, dense (f32 accumulation)
TENSOR_BF16_PEAKS = {
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
}
DEFAULT_CARD = "H100 SXM"
UNITS = ("f32", "bf16_tensor")


def peaks_for(name: str):
    """(row key, (flop/s, bytes/s)) for a device name as CUDA reports it
    ("NVIDIA H100 80GB HBM3" is the SXM part)."""
    for key in ("H100 PCIe", "H100 NVL"):
        if all(w in name for w in key.split()):
            return key, KERNEL_PEAKS[key]
    return DEFAULT_CARD, KERNEL_PEAKS[DEFAULT_CARD]


def bound_terms(flops: float, bytes_accessed: float, card: str = DEFAULT_CARD,
                unit: str = "f32"):
    """(operation-limited s, byte-limited s) for one launch on ``card``,
    its operations of type ``unit`` (one of `UNITS`)."""
    key, (pf, pb) = peaks_for(card)
    if unit == "bf16_tensor":
        pf = TENSOR_BF16_PEAKS[key]
    elif unit != "f32":
        raise ValueError(f"unit {unit!r} not in {UNITS}")
    return flops / pf, bytes_accessed / pb


def kernel_bound_s(flops: float, bytes_accessed: float,
                   card: str = DEFAULT_CARD, unit: str = "f32") -> float:
    """Roofline lower bound for one launch on ``card``: max of the two."""
    return max(bound_terms(flops, bytes_accessed, card, unit))


def bound_by(flops: float, bytes_accessed: float, card: str = DEFAULT_CARD,
             unit: str = "f32") -> str:
    """Which term bounds the launch: ``"operations"`` or ``"bytes"``."""
    ops_s, bytes_s = bound_terms(flops, bytes_accessed, card, unit)
    return "bytes" if bytes_s >= ops_s else "operations"


def achieved_fraction(flops: float, bytes_accessed: float, seconds: float,
                      card: str = DEFAULT_CARD, unit: str = "f32") -> float:
    """bound / measured: 1.0 means the launch ran at the peak model."""
    if seconds <= 0.0:
        return 0.0
    return kernel_bound_s(flops, bytes_accessed, card, unit) / seconds
