"""⟨C⟩ per row (table row 4): the two state planes and the cost plane read.
Its final pass is shared with ∂γ's, whose launches it also serves.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "expectation"
KERNELS = ("expectation_partial_kernel", "expectation_final_kernel")


def work(rows: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(3 * amplitudes), float(3 * 4 * amplitudes)
