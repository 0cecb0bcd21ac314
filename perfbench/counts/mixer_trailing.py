"""The trailing mixer group alone (table row 5): two planes read, two written.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "mixer_group_trailing"
KERNELS = ("fused_kernel<false>",)


def work(rows: int, n: int, group: int = 7) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(6 * group * amplitudes), float(4 * 4 * amplitudes)
