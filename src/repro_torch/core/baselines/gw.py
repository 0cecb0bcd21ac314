"""Goemans–Williamson baseline through the Burer–Monteiro low-rank SDP
(port of ``repro/core/baselines/gw.py``).

The SDP relaxation of Max-Cut, maximize Σ_ij w_ij (1 − ⟨x_i, x_j⟩)/2 over
unit vectors x_i in R^r with r = ⌈√(2V)⌉ (above the Barvinok–Pataki rank
bound), is solved in its factored form by projected gradient ascent, then
rounded by random hyperplanes. The gradient of −½ Σ_e w_e ⟨x_u, x_v⟩ is
written out: ∂/∂x_u = −½ Σ_{e ∋ u} w_e x_other, summed per vertex along
its row of the `graph.Incidence` table (a fixed order, so a card run
repeats bit for bit).

The random draws (the start x0 and the hyperplanes) come from a
``torch.Generator`` seeded with ``seed`` on the run's device; they cannot
equal ``jax.random``'s draws for the same seed. `_bm_optimize` takes x0 and
`_round_hyperplanes` takes the hyperplanes, so a test can feed both
packages the same numpy arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.graph import Graph, Incidence, cut_value_batch, incidence
from repro_torch.core.pei import SolveReport
from repro_torch.device import resolve_device


def _bm_optimize(table: Incidence, x0: torch.Tensor, steps: int, lr: float):
    """``steps`` projected gradient steps on the (n, r) unit rows ``x0``;
    ``table`` is the graph's incidence on x0's device."""
    w = table.weight[:, :, None]
    x = x0
    for _ in range(steps):
        g = -0.5 * torch.sum(w * x[table.nbr], dim=1)
        x = x + lr * g
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    return x


def _round_hyperplanes(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(rounds, n) int8 assignments: the side of each hyperplane row of
    ``h`` (rounds, r) each vector of ``x`` (n, r) lies on."""
    signs = (x @ h.T) >= 0.0  # (n, rounds)
    return signs.T.to(torch.int8)


def goemans_williamson(graph: Graph, steps: int = 300, rounds: int = 64,
                       lr: float = 0.05, seed: int = 0, rank: int | None = None,
                       device: str | torch.device = "cuda"):
    """Returns (assignment (n,) int8, cut value float, SolveReport)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    n = graph.n
    r = rank or max(4, int(np.ceil(np.sqrt(2.0 * n))))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn((n, r), generator=gen, device=dev)
    x0 = x0 / torch.linalg.vector_norm(x0, dim=-1, keepdim=True)
    h = torch.randn((rounds, r), generator=gen, device=dev)

    x = _bm_optimize(incidence(graph, dev), x0, steps, lr)
    assigns = _round_hyperplanes(x, h)
    cuts = cut_value_batch(graph, assigns)
    best = int(torch.argmax(cuts))
    val = float(cuts[best])
    t1 = time.perf_counter()
    report = SolveReport(method="gw", n_vertices=n, cut_value=val, runtime_s=t1 - t0,
                         extra={"rank": r, "steps": steps, "rounds": rounds})
    return assigns[best].cpu().numpy(), val, report
