"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): the yardstick of every roofline and mfu share."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
