"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(port of the JAX package's ``models/moe.py``).

Dispatch is sort-based (dropping, Switch/GShard-style): token→expert
assignments are sorted by expert id, each expert takes up to C slots, and
overflow tokens fall back to the residual path. Expert weights carry a
leading E axis; the per-expert compute is a batched matmul.

Two choices keep a token's bits fixed from run to run on the card:
- top-k is a stable descending sort, so ties go to the lower expert index
  as ``jax.lax.top_k`` breaks them;
- the combine gathers each token's k slots through an inverse slot map
  and adds them in ascending slot order (the order of the reference's
  scatter-add), where an ``index_add_`` would add with atomics in no
  fixed order.

Supports the two assigned MoE archs:
  - moonshot-v1-16b-a3b: 64 experts, top-6
  - arctic-480b: 128 experts, top-2, plus a *dense residual* FFN in
    parallel (Snowflake's dense-MoE hybrid) — `dense_residual=True`.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

# Shard the dispatched capacity axis over the data axes, so the (E, C, D)
# activations scale with the whole mesh instead of only the expert axis.
_CAP_SHARD = False


def set_capacity_sharding(on: bool) -> None:
    global _CAP_SHARD
    _CAP_SHARD = bool(on)


class MoE(nn.Module):
    def __init__(self, d: int, f: int, n_experts: int, dtype,
                 dense_residual: bool = False, f_dense: Optional[int] = None,
                 device=None):
        super().__init__()
        self.router = L.empty_param((d, n_experts), dtype, device)
        self.w_gate = L.empty_param((n_experts, d, f), dtype, device)
        self.w_up = L.empty_param((n_experts, d, f), dtype, device)
        self.w_down = L.empty_param((n_experts, f, d), dtype, device)
        if dense_residual:
            self.dense = L.MLP(d, f_dense or f, "silu", dtype, device)

    def reset(self, gen) -> None:
        L.normal_(self.router, gen, scale=0.01)
        for w in (self.w_gate, self.w_up, self.w_down):
            L.normal_(w, gen)
        if hasattr(self, "dense"):
            self.dense.reset(gen)


def route(params, xf, k: int):
    """Router of the (T, D) tokens: (probs (T, E) f32, gate values (T, k)
    renormalised, expert ids (T, k) int64, ties to the lower index)."""
    logits = torch.matmul(xf.float(), params.router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert takes: ceil(T·k/E·cf), at least 1. It depends on the
    token count, so a decode step (T = B) drops tokens a forward keeps."""
    return max(int(np.ceil(t * k / e * capacity_factor)), 1)


def _route_local(xf, router, k: int, e: int):
    """`route` on a block of tokens, with the one-hot of each token's first
    expert: (probs, gate values, expert ids, one-hot (T, E) f32)."""
    probs, gate_vals, expert_idx = route(SimpleNamespace(router=router), xf, k)
    return probs, gate_vals, expert_idx, F.one_hot(expert_idx[:, 0], e).float()


def moe_apply(
    params,
    x,  # (B, S, D)
    *,
    k: int,
    capacity_factor: float = 1.25,
    dense_residual: bool = False,
):
    """Returns (y, aux_loss). aux_loss is the load-balancing loss.

    On DTensors (the sharded forward) the router runs on each rank's tokens,
    the dispatch tables and the combine on every token, replicated (the
    capacity is global over the batch, as in the reference; DTensor has no
    rule for the sorts and ``searchsorted``), and the expert products over
    the `model` axis as the shard hints place them."""
    b, s, d = x.shape
    e = params.router.shape[-1]
    t = b * s
    xf = x.reshape(t, d)
    tok = (L.batch_axes(t, xf), None) if L.is_dtensor(xf) else (L.DP, None)
    probs, gate_vals, expert_idx, first_hot = L.on_shards(
        functools.partial(_route_local, k=k, e=e), [tok] * 4, (tok, (None, None)),
        xf, params.router,
        note="moe: router on each rank's tokens (local_map), dispatch and combine "
             "replicated (local_map: no rule for sort/searchsorted)")

    # ---- load-balancing auxiliary loss (Switch-style) ---------------------
    me = torch.mean(probs, dim=0)  # (E,)
    ce = torch.mean(first_hot, dim=0)
    aux = e * torch.sum(me * ce)

    # ---- sort-based dispatch ----------------------------------------------
    cap = capacity(t, k, e, capacity_factor)
    rep = (None, None)
    token_of, gate_of, slots = L.on_shards(
        functools.partial(_dispatch, cap=cap, e=e), [(None,), (None,), rep],
        (rep, rep), expert_idx, gate_vals)
    x_e = L.on_shards(functools.partial(_gather_rows, shape=(e, cap, d)),
                      (None, None, None), (rep, (None,)), xf, token_of)  # (E, C, D)
    cap_ax = L.DP if _CAP_SHARD else None
    x_e = L.shard_hint(x_e, "model", cap_ax, None)  # expert-parallel dispatch

    g = torch.bmm(x_e, params.w_gate)
    u = torch.bmm(x_e, params.w_up)
    y_e = torch.bmm(F.silu(g) * u, params.w_down)  # (E, C, D)
    y_e = L.shard_hint(y_e, "model", cap_ax, None)

    y = L.on_shards(functools.partial(_combine, k=k), rep, ((None, None, None), (None,), rep),
                    y_e, gate_of, slots)
    y = y.reshape(b, s, d)

    if dense_residual:
        y = y + L.mlp_apply(params.dense, x, "silu")
    return y.to(x.dtype), aux


def _dispatch(expert_idx, gate_vals, cap: int, e: int):
    """The sort-based dispatch of all T tokens' k assignments: (token_of
    (E·C,), T where a slot is empty; gate_of (E·C,); slots (T, k), each
    assignment's slot, E·C where it dropped, ascending in a row)."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    ea = expert_idx.reshape(-1)  # (T*k,)
    order = torch.sort(ea, stable=True).indices
    sorted_e = ea[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * k, device=dev) - first  # slot within expert

    # slot table: (E*C,) of flat assignment ids, t*k where a slot is empty;
    # a dropped assignment writes to an extra last entry, sliced away (the
    # reference's `mode="drop"`)
    valid = rank < cap
    slot = torch.where(valid, sorted_e * cap + rank, e * cap)
    table = torch.full((e * cap + 1,), t * k, dtype=torch.int64, device=dev)
    table[slot] = order
    table = table[: e * cap]

    filled = table < t * k
    token_of = torch.where(filled, table // k, t)  # t = zero-pad row
    gate_of = torch.where(
        filled, gate_vals.reshape(-1)[table.clamp(max=t * k - 1)], 0.0)
    # each assignment's slot (e*cap: a zero row where it dropped), a
    # token's k slots in ascending slot order
    slot_of = torch.empty(t * k, dtype=torch.int64, device=dev)
    slot_of[order] = slot
    slots = torch.sort(slot_of.reshape(t, k), dim=-1).values
    return token_of, gate_of, slots


def _gather_rows(xf, token_of, shape):
    """The rows ``token_of`` of ``xf`` with a zero row after the last."""
    xp = torch.cat([xf, torch.zeros((1, xf.shape[1]), dtype=xf.dtype, device=xf.device)],
                   dim=0)
    return xp[token_of].reshape(shape)


def _combine(y_e, gate_of, slots, k: int):
    """Each token's k gated expert rows, summed in ascending slot order
    (the order of the reference's scatter-add)."""
    d = y_e.shape[-1]
    y_flat = y_e.reshape(-1, d) * gate_of[:, None].to(y_e.dtype)
    yp = torch.cat([y_flat, torch.zeros((1, d), dtype=y_flat.dtype, device=y_flat.device)])
    parts = yp[slots]  # (T, k, D)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y
