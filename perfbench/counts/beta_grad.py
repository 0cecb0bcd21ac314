"""∂β of the mixer over all qubits (the table's ∂β row): the output planes
and their cotangents read once, four planes.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "beta_grad"
KERNELS = ("beta_grad_kernel", "beta_grad_final_kernel")


def work(rows: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(4 * n * amplitudes), float(4 * 4 * amplitudes)
