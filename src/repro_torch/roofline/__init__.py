"""Roofline bounds of the port's kernels on the H100."""
