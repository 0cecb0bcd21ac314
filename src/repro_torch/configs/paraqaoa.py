"""The paper's own workload as a selectable config: parameter taxonomy of
§4.2 (hardware-dependent / input-dependent / tunable)."""
from repro_torch.core.paraqaoa import ParaQAOAConfig

# production setting: 26-qubit solvers (the paper's GPU cap), pod-scale pool
CONFIG = ParaQAOAConfig(
    n_qubits=26,
    n_solvers=256,  # one per chip on a 16x16 pod
    top_k=2,
    merge_level=2,
    p_layers=3,
    opt_steps=60,
)

# CPU-runnable setting used by tests/benchmarks
REDUCED = ParaQAOAConfig(
    n_qubits=12,
    n_solvers=1,
    top_k=2,
    merge_level=1,
    p_layers=3,
    opt_steps=30,
)
