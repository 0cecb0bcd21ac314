"""Carry state across from the reference package as plain numpy arrays.

The port never imports the JAX package; a caller that holds a reference
graph, problem, set of QAOA angles or LM parameter tree passes their
arrays here.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.graph import Graph, Problem
from repro_torch.models.transformer import LM


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


# the reference's layer stacks: one leading axis of per-layer leaves
STACKED = ("blocks", "enc_blocks")


def flatten(tree, prefix: str = "") -> dict:
    """{"a.b.c": array} of a nested mapping of arrays."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, name + "."))
        else:
            out[name] = val
    return out


def unstack_layers(tree) -> dict:
    """The reference's parameter tree as the port's flat parameter names:
    a stacked leaf ``blocks/attn/wq`` (L, d, H, hd) becomes ``blocks.i.attn.wq``
    (d, H, hd) for each layer i."""
    out = {}
    for top, sub in tree.items():
        if top in STACKED:
            for name, arr in flatten(sub).items():
                arr = np.asarray(arr)
                for i in range(arr.shape[0]):
                    out[f"{top}.{i}.{name}"] = arr[i]
        else:
            out.update(flatten({top: sub}))
    return out


def load_arrays(module: torch.nn.Module, arrays: Mapping):
    """Copy flat ``{name: array}`` into ``module``'s parameters of the same
    names; raises where a name is missing or extra or a shape differs."""
    own = dict(module.named_parameters())
    missing, extra = sorted(own.keys() - arrays.keys()), sorted(arrays.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"parameters missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.array(arrays[name], dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, the port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
    return module


def model_params_from_arrays(cfg, tree, device="cpu"):
    """The port's parameters (``models.transformer.LM``) for ``cfg``, on
    ``device``, holding the reference's parameter tree ``tree`` (numpy
    arrays, layer stacks on a leading axis). Each leaf keeps its layout
    (``wq`` (d, H, hd), ``wo`` (H, hd, d), ...)."""
    params = LM(cfg, device=device)
    return load_arrays(params, unstack_layers(tree))
