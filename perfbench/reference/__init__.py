"""Plain NumPy and PyTorch references for what the solver under test
computes. They import nothing of the solver."""
