"""Kernels of the solve path: CUDA C++ for sm_90a under ``csrc/``, a
wrapper with a launch counter beside each, the plain PyTorch versions in
`ref`, and the dispatch with autograd rules in `ops`. Importing these
modules builds nothing: the kernels compile at first launch (`_build`).
"""
