"""∂γ of the phase rule (the table's ∂γ row): the state planes, their
cotangents and the cost plane read, five planes.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "phase_grad"
KERNELS = ("phase_grad_partial_kernel",)


def work(rows: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(4 * amplitudes), float(5 * 4 * amplitudes)
