"""The single-device statevector engine (the flat path of
``repro/core/engine.py``).

`FlatLayout` holds the full 2^n statevector of every batch row in basis
order; `evolve` runs the p-layer ansatz with every op going through the
`kernels.ops` dispatch, differentiable in the angles through the ops'
autograd rules; `adam_scan` is the reference's Adam rule, exactly. The
model-axis sharded layout is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Single-device layout: the full 2^n statevector in basis order."""

    n: int
    group: int = 7


class CutTable(NamedTuple):
    """Diagonal cost of the flat layout: ``cutv_a`` (B, 2^n) in basis order
    (the sharded layout's other views are not ported)."""

    cutv_a: torch.Tensor


def init_state(layout: FlatLayout, batch: int, device):
    """|+>^n as (re, im) planes, (B, 2^n) each."""
    dim = 2**layout.n
    re = torch.full((batch, dim), 2.0 ** (-layout.n / 2), dtype=torch.float32,
                    device=device)
    im = torch.zeros((batch, dim), dtype=torch.float32, device=device)
    return re, im


def evolve(layout: FlatLayout, cut: CutTable, gammas, betas):
    """Run the p-layer ansatz from |+>^n; gammas, betas (B, p).

    Returns the final (re, im) planes. Each layer is one `ops.apply_layer`
    whose inputs are the previous layer's outputs, so autograd keeps one
    state pair per layer and no copies.
    """
    re, im = init_state(layout, cut.cutv_a.shape[0], cut.cutv_a.device)
    for l in range(gammas.shape[1]):
        re, im = ops.apply_layer(re, im, cut.cutv_a, gammas[:, l], betas[:, l],
                                 layout.n, group=layout.group)
    return re, im


def expectation(layout: FlatLayout, re, im, cut: CutTable):
    """⟨cut⟩ of the evolved state per row: (B,)."""
    return ops.expectation(re, im, cut.cutv_a)


def adam_scan(grad_fn: Callable, params: tuple, steps: int,
              learning_rate: float) -> tuple:
    """Adam descent on ``grad_fn`` for ``steps``: ``engine.adam_scan`` of the
    reference (engine.py:251-281), step for step in float32.

    The step counter is an f32 ``arange`` and the bias corrections are
    ``1 - beta^t`` in f32, as in the reference; `torch.optim.Adam` rounds
    its bias correction differently. Every tensor is per batch row.
    """
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    params = tuple(p.detach() for p in params)
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    dev = params[0].device
    b1 = torch.tensor(beta1, dtype=torch.float32, device=dev)
    b2 = torch.tensor(beta2, dtype=torch.float32, device=dev)
    for i in torch.arange(steps, dtype=torch.float32, device=dev):
        g = grad_fn(params)
        m = tuple(beta1 * a + (1 - beta1) * b for a, b in zip(m, g))
        v = tuple(beta2 * a + (1 - beta2) * b * b for a, b in zip(v, g))
        t = i + 1
        mh = tuple(a / (1 - b1**t) for a in m)
        vh = tuple(a / (1 - b2**t) for a in v)
        params = tuple(p - learning_rate * a / (torch.sqrt(b) + eps)
                       for p, a, b in zip(params, mh, vh))
    return params
