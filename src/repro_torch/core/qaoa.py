"""Statevector QAOA for a batch of subgraphs (port of ``repro/core/qaoa.py``).

One QAOA layer is an elementwise phase by the per-basis-state objective
followed by the transverse-field mixer RX(2β)^{⊗n}; the evolution runs in
`core.engine` with every op dispatched through `kernels.ops`. The JAX
package solves one subgraph per call under ``jax.vmap``; here the batch
is written out: every function takes (B, …) tensors, every subgraph has
its own angles, Adam moments and cotangents, and one kernel launch per op
covers the whole batch. A batch larger than the card holds runs in rounds
(`solve_subgraph_batch`), sized by `max_rows_per_round` from the card's
memory. `rows_on_card` is the one memory rule of both statevector engines:
each states its bytes a row, this one's is `row_bytes`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.kernels import ops
from repro_torch.obs import trace as trace_mod

# peak device bytes of one row of a round (`solve_batch_on_device` and its
# top-K) per amplitude, ROW_BYTES_BASE + ROW_BYTES_PER_LAYER · p: measured
# on an H100 at n = 24 and 26, p = 1, 2 and 3 (44, 52, 60; PERF.md §4)
ROW_BYTES_BASE, ROW_BYTES_PER_LAYER = 36, 8
MEMORY_SHARE = 0.9  # of the card's unallocated memory a launch may plan to fill


@dataclasses.dataclass(frozen=True)
class QAOAConfig:
    n_qubits: int  # statevector size (subgraphs padded to this)
    p_layers: int = 3
    opt_steps: int = 30
    learning_rate: float = 0.05
    ramp_delta: float = 0.75  # linear-ramp initialization scale
    top_k: int = 4  # paper's K (Selective Distribution Exploration)
    mixer_group: int = 7  # qubits per mixer group (2^7 = 128 amplitudes)


class QAOAResult(NamedTuple):
    bitstrings: torch.Tensor  # (B, K) int32 basis indices (pad bits 0)
    probs: torch.Tensor  # (B, K) float32 marginal probabilities
    expectation: torch.Tensor  # (B,) final ⟨cut⟩
    gammas: torch.Tensor  # (B, p) optimized
    betas: torch.Tensor  # (B, p)


def linear_ramp_init(p: int, delta: float, device=None):
    """γ_l ramps up, β_l ramps down: a discretized annealing schedule, (p,)."""
    l = (torch.arange(p, dtype=torch.float32, device=device) + 0.5) / p
    return delta * l, delta * (1.0 - l)


def qaoa_statevector(cutv, n: int, gammas, betas, group: int = 7):
    """Run the p-layer ansatz for every row; (re, im) planes (B, 2^n)."""
    layout = engine.FlatLayout(n=n, group=group)
    re, im, _ = engine.evolve(layout, engine.CutTable(cutv), gammas, betas)
    return re, im


def qaoa_expectation(params, cutv, n: int, group: int = 7):
    gammas, betas = params
    re, im = qaoa_statevector(cutv, n, gammas, betas, group=group)
    return ops.expectation(re, im, cutv)


def optimize_params(cutv, n: int, cfg: QAOAConfig):
    """Adam ascent on ⟨cut⟩ of every row; optimized (gammas, betas) (B, p).

    The loss is −⟨cut⟩ per row; the rows are summed only to call
    ``backward`` once, which leaves each row's gradient its own.
    """
    b = cutv.shape[0]
    g0, b0 = linear_ramp_init(cfg.p_layers, cfg.ramp_delta, device=cutv.device)
    params = (g0.expand(b, -1).contiguous(), b0.expand(b, -1).contiguous())

    def grad_fn(params):
        leaves = [x.detach().requires_grad_(True) for x in params]
        loss = -qaoa_expectation(leaves, cutv, n, group=cfg.mixer_group)
        return torch.autograd.grad(loss.sum(), leaves)

    return engine.adam_scan(grad_fn, params, cfg.opt_steps, cfg.learning_rate)


def fold_pad_bits(probs, n_real: int):
    """(R, 2^n) probabilities → (R, 2^n_real) marginals over the real
    qubits. The padding qubits are the high bits, so the fold halves the
    pad axis until it is gone: each step adds the upper half onto the
    lower, elementwise. The order of the adds is fixed by the shape alone,
    so a row's bits depend neither on the other rows nor on the device (a
    reduction kernel may pick its split from the row count)."""
    x = probs.reshape(probs.shape[0], -1, 2**n_real)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def topk_marginal(re, im, n: int, real_mask, k: int):
    """Top-k bitstrings of each row's marginal over its real qubits.

    ``real_mask`` (B,) is 2^n_real − 1 per row, on the host (a numpy array
    or a CPU tensor): it says which rows fold together, which is host work,
    so nothing here waits for the card. Rows with the same n_real (at most
    two values for a balanced partition, and 1 for filler rows) fold
    together (`fold_pad_bits`). Returns (indices (B, k) int32, marginals
    (B, k) f32).
    """
    if isinstance(real_mask, torch.Tensor) and real_mask.device.type != "cpu":
        raise ValueError("real_mask must be on the host")
    probs = re * re + im * im
    b = probs.shape[0]
    n_real = np.array([int(m).bit_length() for m in np.asarray(real_mask)])
    inds = torch.empty((b, k), dtype=torch.int32, device=probs.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=probs.device)
    for nr in sorted(set(n_real.tolist())):
        rows = to_device(np.flatnonzero(n_real == nr), probs.device)
        marg = fold_pad_bits(probs[rows], nr)
        if k > 2**nr:  # the keys past 2^n_real carry zero mass
            marg = torch.nn.functional.pad(marg, (0, 2**n - 2**nr))
        v, i = engine.stable_topk(marg, k)
        inds[rows] = i.to(torch.int32)
        vals[rows] = v
    return inds, vals


def solve_subgraph_batch(edges, weights, real_mask, cfg: QAOAConfig,
                         linear=None) -> QAOAResult:
    """End-to-end QAOA solve of a padded subgraph batch.

    edges (B, E, 2) int32, weights (B, E) f32 and ``linear`` (B, n_qubits)
    f32 or None on one device; real_mask (B,) on the host. The rows run in
    the rounds of `round_slices`, as many rows a round as
    `max_rows_per_round` plans on the inputs' device (one round off the
    card), each the device span ``qaoa_round``: one call of
    `solve_batch_on_device`, with one kernel launch per op covering the
    round's rows, then the round's top-K; its states are dropped before
    the next round starts. Rows do not depend on their batch, so the
    joined result equals the result of one round, bit for bit. On the card
    nothing here reads the card back, so the call returns once its
    launches are queued (or, behind a stall longer than the card's launch
    queue, once the queue has room); reading the result waits for them.
    """
    tr = trace_mod.get_tracer()
    parts = []
    per_round = max_rows_per_round(cfg.n_qubits, cfg.p_layers, edges.device)
    for r, rows in enumerate(round_slices(edges.shape[0], per_round)):
        with tr.device_span("qaoa_round", edges.device, round=r,
                            rows=rows.stop - rows.start):
            gammas, betas, re, im, exp = solve_batch_on_device(
                edges[rows], weights[rows], cfg,
                None if linear is None else linear[rows])
            with torch.no_grad(), tr.device_span("top_k", re.device):
                bits, probs = topk_marginal(re, im, cfg.n_qubits, real_mask[rows],
                                            cfg.top_k)
            del re, im  # this round's states, before the next round's
        parts.append(QAOAResult(bits, probs, exp, gammas, betas))
    if len(parts) == 1:
        return parts[0]
    return QAOAResult(*(torch.cat(field) for field in zip(*parts)))


def round_slices(b: int, per_round: int | None) -> list[slice]:
    """``b`` rows in the fewest rounds of at most ``per_round`` (all in one
    when None), as even as they go: T = ⌈b / per_round⌉ rounds of ⌈b / T⌉
    rows, the last with the rest."""
    rounds = 1 if per_round is None else -(-b // per_round)
    size = -(-b // rounds)
    return [slice(s, min(s + size, b)) for s in range(0, b, size)]


def row_bytes(n: int, p: int) -> int:
    """Peak device bytes one row of n qubits and p layers holds in a round."""
    return (ROW_BYTES_BASE + ROW_BYTES_PER_LAYER * p) << n


def rows_that_fit(bytes_a_row: int, free_bytes: int) -> int:
    """The most rows of ``bytes_a_row`` each a launch may take within
    `MEMORY_SHARE` of ``free_bytes``; raises where not one row fits."""
    rows = int(MEMORY_SHARE * free_bytes) // bytes_a_row
    if rows < 1:
        raise MemoryError(
            f"one row needs {bytes_a_row:,} B, more than {MEMORY_SHARE:.0%} of "
            f"the {free_bytes:,} B the card has free")
    return rows


def rows_on_card(bytes_a_row: int, device: torch.device | str) -> int | None:
    """The rows of ``bytes_a_row`` each one launch may take on ``device``:
    `rows_that_fit` the card's total memory less what is allocated (what
    the caching allocator keeps reserved counts as free, where
    `torch.cuda.mem_get_info` would count it as used). None, no limit, off
    the card. The one place that reads the card's memory to size a launch,
    for the flat engine's rounds and the sharded engine's launches."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return rows_that_fit(bytes_a_row, total - torch.cuda.memory_allocated(device))


def max_rows_per_round(n: int, p: int, device: torch.device | str) -> int | None:
    """The rows a round of `solve_subgraph_batch` may take on ``device``:
    `rows_on_card` at `row_bytes` (n, p)."""
    return rows_on_card(row_bytes(n, p), device)


def solve_subgraph(edges, weights, real_mask, cfg: QAOAConfig,
                   linear=None) -> QAOAResult:
    """End-to-end QAOA solve of one padded subgraph: edges (E, 2) int32,
    weights (E,) f32, ``linear`` (n_qubits,) f32 or None, real_mask
    2^n_real − 1 on the host. The batch of one: row 0 of
    `solve_subgraph_batch`, whose rows do not depend on their batch, with
    the batch axis dropped from every field."""
    masks = np.asarray(real_mask, dtype=np.int64).reshape(1)
    res = solve_subgraph_batch(edges[None], weights[None], masks, cfg,
                               linear=None if linear is None else linear[None])
    return QAOAResult(*(t[0] for t in res))


def index_to_bits(indices: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) int32 basis indices → (..., n) int8 bits (bit q = vertex q)."""
    shifts = torch.arange(n, dtype=indices.dtype, device=indices.device)
    return ((indices[..., None] >> shifts) & 1).to(torch.int8)


def solve_batch_on_device(edges, weights, cfg: QAOAConfig, linear=None):
    """The part of `solve_subgraph_batch` that needs nothing from the host:
    the cost diagonal, the Adam ascent, the final evolution and ⟨cut⟩.
    Returns (gammas, betas, re, im, expectation). Every shape in it is
    fixed by the inputs' shapes and ``cfg``, so on the card it can be
    captured as one CUDA graph (`service.backend.LocalBackend`). Its three
    parts are the device spans ``cost_table``, ``adam_step`` (one a step)
    and ``final_state``."""
    n = cfg.n_qubits
    tr = trace_mod.get_tracer()
    with tr.device_span("cost_table", edges.device):
        cutv = ops.cutvals(n, edges, weights, linear)
    gammas, betas = optimize_params(cutv, n, cfg)
    with torch.no_grad(), tr.device_span("final_state", cutv.device):
        re, im = qaoa_statevector(cutv, n, gammas, betas, group=cfg.mixer_group)
        exp = ops.expectation(re, im, cutv)
    return gammas, betas, re, im, exp


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To the card it goes through
    pinned memory with ``non_blocking=True``: a copy from pageable memory
    waits for the stream, and with it for every launch queued before."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_subgraph_arrays(subgraphs, n_qubits: int, e_pad: int | None = None,
                        n_rows: int | None = None, device="cpu"):
    """Stack per-subgraph (edges, weights, real_mask) into batch tensors:
    edges and weights on ``device``, the masks on the host (the solve
    groups rows by them there).

    ``n_rows`` pads the batch with empty filler rows (mask 1, no edges).
    """
    if e_pad is None:
        e_pad = max(max(g.edges.shape[0] for g in subgraphs), 1)
    b = len(subgraphs)
    rows = b if n_rows is None else n_rows
    assert rows >= b, (rows, b)
    edges = np.zeros((rows, e_pad, 2), dtype=np.int32)
    weights = np.zeros((rows, e_pad), dtype=np.float32)
    masks = np.ones((rows,), dtype=np.int32)
    for i, g in enumerate(subgraphs):
        m = g.edges.shape[0]
        assert m <= e_pad, (m, e_pad)
        assert g.n <= n_qubits, (g.n, n_qubits)
        edges[i, :m] = np.asarray(g.edges)
        weights[i, :m] = np.asarray(g.weights)
        masks[i] = (1 << g.n) - 1
    return (to_device(edges, device), to_device(weights, device),
            torch.from_numpy(masks))


def pad_linear_arrays(linears, n_qubits: int, n_rows: int | None = None,
                      device="cpu"):
    """Stack per-subgraph linear terms into one (rows, n_qubits) f32 tensor,
    zero-padded on both axes (padding contributes h = 0)."""
    b = len(linears)
    rows = b if n_rows is None else n_rows
    assert rows >= b, (rows, b)
    out = np.zeros((rows, n_qubits), dtype=np.float32)
    for i, l in enumerate(linears):
        l = np.asarray(l, dtype=np.float32)
        assert l.shape[0] <= n_qubits, (l.shape[0], n_qubits)
        out[i, : l.shape[0]] = l
    return to_device(out, device)
