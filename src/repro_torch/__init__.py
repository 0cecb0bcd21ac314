"""ParaQAOA in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``repro`` module by module, at the same relative
paths (``src/repro_torch/core/qaoa.py`` ↔ ``src/repro/core/qaoa.py``). It imports neither
JAX nor ``repro``. Entry points run on the GPU (``device="cuda"``) and raise
when no GPU is present; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels instead.
"""
