"""The cost diagonal (table row 1): one f32 plane written; the edge list
read is too small to count. Operations: none that the table's bound counts.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "cutvals"
KERNELS = ("cutvals_tables", "cutvals_fill")


def work(rows: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(0), float(1 * 4 * amplitudes)
