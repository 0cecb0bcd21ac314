"""Carry state across from the reference package as plain numpy arrays.

The port never imports the JAX package; a caller that holds a reference
graph, problem or set of QAOA angles passes their arrays here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, Problem


def problem_from_arrays(n: int, edges, weights, n_edges: int, linear=None,
                        offset: float = 0.0, kind: str = "maxcut"):
    """The port's `Graph` (Max-Cut without linear terms or offset) or
    `Problem` from padded edge arrays: edges (E_pad, 2) int32, weights
    (E_pad,) f32, ``linear`` (n,) f32."""
    graph = Graph(
        n=int(n),
        edges=torch.from_numpy(np.array(edges, dtype=np.int32)),
        weights=torch.from_numpy(np.array(weights, dtype=np.float32)),
        n_edges=int(n_edges),
    )
    if linear is None and offset == 0.0 and kind == "maxcut":
        return graph
    lin = (torch.zeros(graph.n, dtype=torch.float32) if linear is None
           else torch.from_numpy(np.array(linear, dtype=np.float32)))
    return Problem(graph=graph, linear=lin, offset=float(offset), kind=kind)


def angles_from_arrays(gammas, betas, device="cpu"):
    """QAOA angles as (B, p) float32 tensors; a (p,) array becomes one row."""
    def t(a):
        a = np.array(a, dtype=np.float32)
        return torch.from_numpy(a.reshape(-1, a.shape[-1])).to(device)

    return t(gammas), t(betas)
