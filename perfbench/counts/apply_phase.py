"""The cost phase alone (table row 6): two state planes and the cost plane
read, two planes written.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "apply_phase"
KERNELS = ("apply_phase_kernel",)


def work(rows: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(7 * amplitudes), float(5 * 4 * amplitudes)
