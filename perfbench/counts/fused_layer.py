"""The cost phase and the first mixer group, forward or adjoint (table row
2): the two state planes and the cost plane read, two planes written.
Operations: the phase's complex product (7) and each mixer qubit's 2×2
rotation (6 an amplitude).

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "fused_phase_mixer_group"
KERNELS = ("fused_kernel<true>",)


def work(rows: int, n: int, group: int = 7) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float((7 + 6 * group) * amplitudes), float(5 * 4 * amplitudes)
