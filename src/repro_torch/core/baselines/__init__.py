"""Classical and quantum baselines: exhaustive search, Goemans–Williamson,
1-flip local search (and the solve's refinement), QAOA²."""

from repro_torch.core.baselines.brute_force import brute_force_maxcut
from repro_torch.core.baselines.gw import goemans_williamson
from repro_torch.core.baselines.local_search import local_search, refine
from repro_torch.core.baselines.qaoa_in_qaoa import qaoa_in_qaoa

__all__ = [
    "brute_force_maxcut",
    "goemans_williamson",
    "local_search",
    "refine",
    "qaoa_in_qaoa",
]
