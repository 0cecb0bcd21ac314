"""ParaQAOA core in PyTorch: graphs, partition, batched QAOA, merge, solve,
and the solve on a device mesh."""

from repro_torch.core.axis import LocalAxis, Mesh, ProcessGroupAxis
from repro_torch.core.graph import (Graph, Problem, as_problem, cut_value, cut_value_batch,
                                    problem_value)
from repro_torch.core.paraqaoa import ParaQAOAConfig, ParaQAOAOutput, solve
from repro_torch.core.partition import (
    Partition,
    connectivity_preserving_partition,
    partition_for_solver,
    random_partition,
)
from repro_torch.core.pei import approximation_ratio, efficiency_factor, pei
from repro_torch.core.distributed import (merge_sharded, sharded_qaoa, solve_distributed,
                                          solve_pool)

__all__ = [
    "Graph",
    "Problem",
    "as_problem",
    "cut_value",
    "cut_value_batch",
    "problem_value",
    "Partition",
    "connectivity_preserving_partition",
    "partition_for_solver",
    "random_partition",
    "ParaQAOAConfig",
    "ParaQAOAOutput",
    "solve",
    "solve_distributed",
    "solve_pool",
    "sharded_qaoa",
    "merge_sharded",
    "LocalAxis",
    "Mesh",
    "ProcessGroupAxis",
    "approximation_ratio",
    "efficiency_factor",
    "pei",
]
