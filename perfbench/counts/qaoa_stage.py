"""The whole batched QAOA stage of one solve, counted from (rows, n, p, T, K)
as the algorithm needs it and not from any kernel: the same work whatever
kernels carry it, so it bounds a gain after kernels are fused or removed.

Bytes, f32 (4 bytes), ``rows`` subgraphs of 2^n amplitudes:
  - the cost table: one plane written;
  - each Adam step: p layer passes forward and p adjoint passes, each one
    read and one write of the state's two planes;
  - the final evolve: p forward passes;
  - the top-K: the two final planes read once.
Operations, per amplitude of a pass: the phase's complex product (7) and
each qubit's 2×2 rotation (6). Gradients, ⟨C⟩ and the reads of the cost
table are left out: the count is what no implementation can avoid.
"""

STAGE = "solve_pool"


def work(rows: int, n: int, p: int, steps: int) -> tuple[float, float]:
    """(operations, bytes) of one solve's QAOA stage."""
    amplitudes = rows * 2**n
    passes = 2 * p * steps + p
    ops = passes * (7 + 6 * n) * amplitudes
    nbytes = (1 + 4 * passes + 2) * 4 * amplitudes
    return float(ops), float(nbytes)
