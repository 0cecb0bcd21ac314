"""The statevector engine under every QAOA solve path (the port of
``repro/core/engine.py``).

`FlatLayout` holds the full 2^n statevector of every batch row in basis
order. `ShardedLayout` holds 2^n amplitudes over the D shards of a
`model` axis (`core.axis`): each shard keeps L = 2^(n-h) of them, and a
tensor on it has one row per (subgraph, local shard). `evolve` runs the
p-layer ansatz with every op going through the `kernels.ops` dispatch,
differentiable in the angles through the ops' autograd rules and the
swap's; `adam_scan` is the reference's Adam rule, exactly.

Layout-B geometry: in layout A shard d owns global indices
[d·L, (d+1)·L); after the qubit swap (layout B) shard p owns, for every
d, the slice [d·L + p·chunk, d·L + (p+1)·chunk) with chunk = L / D. In
layout B the local index's bits [log2(chunk), log2(chunk) + h) are the
original high h qubits, so one local `apply_mixer_bits` call mixes the
qubits that were out of reach in layout A. The cost is diagonal, so the
alternating schedule stays in layout B for the next layer and reads the
cut values through the layout-B index map instead of swapping back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.axis import LocalAxis, ProcessGroupAxis
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_mod

# elements one sort call takes: bounds the sort's scratch on the card
# (a 2^26-element stable sort with int64 indices needs ~2 GB)
SORT_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Single-device layout: the full 2^n statevector in basis order."""

    n: int
    group: int = 7


@dataclasses.dataclass(frozen=True)
class ShardedLayout:
    """Model-axis sharded layout over ``axis`` (a `LocalAxis` or a
    `ProcessGroupAxis`), with the ``faithful`` (swap in and back, two swaps
    a layer) or ``alternating`` (one swap a layer) schedule."""

    n: int
    axis: Union[LocalAxis, ProcessGroupAxis]
    schedule: str = "alternating"
    group: int = 7

    def __post_init__(self):
        if self.axis.size < 2:
            raise ValueError("a sharded layout needs an axis of 2 or more shards")
        if self.chunk < 1:
            raise ValueError(f"statevector too small for the mesh: n={self.n}, "
                             f"axis={self.axis.size}")
        if self.schedule not in ("faithful", "alternating"):
            raise ValueError(f"unknown schedule {self.schedule!r}")

    @property
    def h(self) -> int:
        """Number of shard-axis ("global") qubits."""
        return self.axis.h

    @property
    def n_local(self) -> int:
        return self.n - self.h

    @property
    def local_dim(self) -> int:
        """L: amplitudes resident per shard."""
        return 2**self.n_local

    @property
    def chunk(self) -> int:
        """Block size of the swap: L / D."""
        return self.local_dim // self.axis.size

    @property
    def log2_chunk(self) -> int:
        return self.n_local - self.h


Layout = Union[FlatLayout, ShardedLayout]


class CutTable(NamedTuple):
    """Diagonal cost per layout position, (rows, width) each.

    Flat layouts carry only ``cutv_a`` (basis order). Sharded layouts carry
    the layout-A view and its (local, L) index table, and, under the
    alternating schedule, the layout-B view and table; the faithful
    schedule never reads layout B, so it is not built (the JAX engine
    builds it and leaves XLA to drop it).
    """

    cutv_a: torch.Tensor
    idx_a: Optional[torch.Tensor] = None
    cutv_b: Optional[torch.Tensor] = None
    idx_b: Optional[torch.Tensor] = None

    def at(self, in_b: bool) -> torch.Tensor:
        return self.cutv_b if in_b else self.cutv_a

    def idx(self, in_b: bool) -> torch.Tensor:
        return self.idx_b if in_b else self.idx_a


def layout_index_maps(layout: ShardedLayout, device: int):
    """Layout-A/B global-index rows (numpy int64) of shard ``device``."""
    L, chunk = layout.local_dim, layout.chunk
    q = np.arange(L, dtype=np.int64)
    idx_a = device * L + q
    idx_b = (q // chunk) * L + device * chunk + (q % chunk)
    return idx_a, idx_b


def index_tables(layout: ShardedLayout, device):
    """(idx_a, idx_b), each (local, L) int32: the global index of every
    position of the shards this process holds. They depend on (n, D) and
    the shard, not on the subgraph, so one table serves the whole batch."""
    L, chunk = layout.local_dim, layout.chunk
    me = torch.arange(layout.axis.offset, layout.axis.offset + layout.axis.local,
                      dtype=torch.int32, device=device)[:, None]
    q = torch.arange(L, dtype=torch.int32, device=device)[None, :]
    return me * L + q, (q // chunk) * L + me * chunk + (q % chunk)


def cut_table(layout: ShardedLayout, edges, weights, linear=None) -> CutTable:
    """Objective values of every owned basis state, in every layout the
    schedule visits; edges (B, E, 2), weights (B, E), ``linear`` (B, n).
    (The flat path's table is `ops.cutvals`.)"""
    idx_a, idx_b = index_tables(layout, edges.device)
    n = layout.n  # every index lies below 2^n: no read of idx.max()
    cutv_a = ops.cutvals_at(idx_a, edges, weights, linear, n_bits=n)
    if layout.schedule == "faithful":
        return CutTable(cutv_a, idx_a)
    return CutTable(cutv_a, idx_a,
                    ops.cutvals_at(idx_b, edges, weights, linear, n_bits=n), idx_b)


def init_state(layout: Layout, batch: int, device):
    """|+>^n as (re, im) planes: (B, 2^n) flat, (B·local, L) sharded."""
    if isinstance(layout, FlatLayout):
        shape = (batch, 2**layout.n)
    else:
        shape = (batch * layout.axis.local, layout.local_dim)
    re = torch.full(shape, 2.0 ** (-layout.n / 2), dtype=torch.float32,
                    device=device)
    return re, torch.zeros(shape, dtype=torch.float32, device=device)


def evolve(layout: Layout, cut: CutTable, gammas, betas):
    """Run the p-layer ansatz from |+>^n; gammas, betas (B, p).

    Returns ``(re, im, in_b)``: the final planes and whether they end in
    layout B (odd p under the alternating schedule). Each layer's inputs
    are the previous op's outputs, so autograd keeps no copies. On a
    sharded layout each subgraph's angles serve all its shard rows, so
    autograd sums their gradient over those rows.
    """
    rows = cut.cutv_a.shape[0]
    dev = cut.cutv_a.device
    p = gammas.shape[1]
    if isinstance(layout, FlatLayout):
        re, im = init_state(layout, rows, dev)
        for l in range(p):
            re, im = ops.apply_layer(re, im, cut.cutv_a, gammas[:, l],
                                     betas[:, l], layout.n, group=layout.group)
        return re, im, False

    local, axis = layout.axis.local, layout.axis
    gammas = gammas.repeat_interleave(local, dim=0)
    betas = betas.repeat_interleave(local, dim=0)
    re, im = init_state(layout, rows // local, dev)
    in_b = False
    for l in range(p):
        g, b = gammas[:, l], betas[:, l]
        # phase + the n-h locally resident qubits
        re, im = ops.apply_layer(re, im, cut.at(in_b), g, b, layout.n_local,
                                 group=layout.group)
        # rotate the h axis qubits into locality and mix them: after the
        # swap they sit at local bits [log2_chunk, log2_chunk + h)
        re, im = axis.swap(re, layout.chunk), axis.swap(im, layout.chunk)
        re, im = ops.apply_mixer_bits(re, im, layout.n_local, layout.log2_chunk,
                                      layout.h, b)
        if layout.schedule == "alternating":
            in_b = not in_b
        else:  # faithful: swap straight back to layout A
            re, im = axis.swap(re, layout.chunk), axis.swap(im, layout.chunk)
    return re, im, in_b


def expectation(layout: Layout, re, im, cut: CutTable, in_b: bool = False):
    """⟨cut⟩ of the evolved state per subgraph, (B,); summed over the axis
    on a sharded layout."""
    e = ops.expectation(re, im, cut.at(in_b))
    if isinstance(layout, ShardedLayout):
        e = layout.axis.sum(e)
    return e


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis with ``jax.lax.top_k``'s tie order: among
    equal values the lower index comes first (a stable descending sort).
    Rows of a 2-D ``x`` are sorted at most `SORT_CHUNK` elements at a time.
    Returns (values, indices int64)."""
    if x.dim() == 2 and x.numel() > SORT_CHUNK:
        step = max(1, SORT_CHUNK // x.shape[1])
        parts = [stable_topk(x[r:r + step], k) for r in range(0, x.shape[0], step)]
        return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_candidates(layout: ShardedLayout, re, im, cut: CutTable, in_b: bool,
                   k: int):
    """Top-k (global basis indices int32, probabilities) per subgraph,
    (B, k) each, the same on every process: each shard's local top-k,
    gathered in shard order, then top-k again, so ties go to the lower
    position of the gathered array, as in ``engine.py:234-245``. (The
    flat path takes the marginal's top-k, `qaoa.topk_marginal`.)
    """
    probs = re * re + im * im
    v, i_loc = stable_topk(probs, k)
    del probs
    local = layout.axis.local
    idx = cut.idx(in_b)
    b = v.shape[0] // local
    owned = torch.gather(idx.unsqueeze(0).expand(b, -1, -1), 2,
                         i_loc.view(b, local, k)).view(b * local, k)
    all_v = layout.axis.gather(v)
    all_i = layout.axis.gather(owned)
    vv, ii = stable_topk(all_v, k)
    return all_i.gather(1, ii), vv


# ---------------------------------------------------------------------------
# parameter optimization
# ---------------------------------------------------------------------------
def adam_scan(grad_fn: Callable, params: tuple, steps: int,
              learning_rate: float) -> tuple:
    """Adam descent on ``grad_fn`` for ``steps``: ``engine.adam_scan`` of the
    reference (engine.py:251-281), step for step in float32.

    The step counter is an f32 ``arange`` and the bias corrections are
    ``1 - beta^t`` in f32, as in the reference; `torch.optim.Adam` rounds
    its bias correction differently. Every tensor is per batch row.
    Each step is an ``adam_step`` device span whose ``step`` attribute
    counts on the host: a read of ``i`` would wait for the card.
    """
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    params = tuple(p.detach() for p in params)
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    dev = params[0].device
    # filled on the device: a tensor made from a host value is a copy that
    # waits for the stream
    b1 = torch.full((), beta1, dtype=torch.float32, device=dev)
    b2 = torch.full((), beta2, dtype=torch.float32, device=dev)
    tr = trace_mod.get_tracer()
    for step, i in enumerate(torch.arange(steps, dtype=torch.float32, device=dev)):
        with tr.device_span("adam_step", dev, step=step):
            g = grad_fn(params)
            m = tuple(beta1 * a + (1 - beta1) * b for a, b in zip(m, g))
            v = tuple(beta2 * a + (1 - beta2) * b * b for a, b in zip(v, g))
            t = i + 1
            mh = tuple(a / (1 - b1**t) for a in m)
            vh = tuple(a / (1 - b2**t) for a in v)
            params = tuple(p - learning_rate * a / (torch.sqrt(b) + eps)
                           for p, a, b in zip(params, mh, vh))
    return params


def sharded_ascent(layout: ShardedLayout, cut: CutTable, gammas, betas,
                   steps: int, learning_rate: float) -> tuple:
    """Adam ascent on each subgraph's global ⟨cut⟩ through the sharded
    evolution; gammas, betas (B, p).

    The loss is the local (unsummed) expectation of this process's shard
    rows. Autograd sums each subgraph's gradient over its local rows, and
    `reduce` over the processes of the axis (the ``psum`` at
    ``engine.py:320-323``), so every process takes the same Adam steps.
    """

    def grad_fn(params):
        leaves = [x.detach().requires_grad_(True) for x in params]
        re, im, in_b = evolve(layout, cut, *leaves)
        loss = -ops.expectation(re, im, cut.at(in_b)).sum()
        return tuple(layout.axis.reduce(g)
                     for g in torch.autograd.grad(loss, leaves))

    return adam_scan(grad_fn, (gammas, betas), steps, learning_rate)
