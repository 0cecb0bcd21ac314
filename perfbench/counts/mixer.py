"""One strided mixer group (table row 3): two planes read, two written.

Counted from the shapes as the algorithm needs them: each input byte read
once, each output byte written once, f32 (4 bytes). ``rows`` subgraphs of
2^n amplitudes.
"""

OP = "mixer_group_strided"
KERNELS = ("mixer_strided_kernel",)


def work(rows: int, n: int, group: int = 7) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    amplitudes = rows * 2**n
    return float(6 * group * amplitudes), float(4 * 4 * amplitudes)
