"""The benchmark of the ParaQAOA solver's PyTorch and CUDA port (run.py)."""
