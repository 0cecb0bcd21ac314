"""Level-Aware Parallel Merge, paper Alg. 2 (port of ``repro/core/merge.py``).

A level-synchronous frontier ("beam") of (partial global assignment,
partial score) rows is swept over the subgraph levels: level 0 seeds both
orientations of subgraph 1's K candidates; every later level extends each
row by the K candidates of its subgraph, oriented so the shared vertex
agrees (an int8 XOR flip), scores the level's bucket of original-graph
edges and linear terms incrementally, and keeps the best ``beam_width``
rows. With ``beam_width >= 2·K^M`` nothing is pruned and the sweep is the
paper's exhaustive search. `merge_scan` sweeps every level in one call
(striped over shards where asked); `merge_stream` is its anytime form, one
level at a time with a complete best-known cut after each.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core.partition import Partition
from repro_torch.core.engine import stable_topk
from repro_torch.obs import trace as trace_mod

NEG = -1e30  # score of an empty frontier row


class MergePlan(NamedTuple):
    """Host-prepared, shape-stable inputs of the merge sweep."""

    n_vert: int  # true vertex count V
    n_pad: int  # padded assignment width (V + n_max)
    n_max: int  # max subgraph size
    k: int  # candidates per subgraph
    lo: torch.Tensor  # (M,) int32 window starts
    cand_bits: torch.Tensor  # (M, K, n_max) int8 candidate bit arrays
    edge_u: torch.Tensor  # (M, E_lv) int32 earlier-covered endpoint
    edge_v: torch.Tensor  # (M, E_lv) int32 later-covered endpoint (>= lo)
    edge_w: torch.Tensor  # (M, E_lv) float32
    lin: torch.Tensor  # (M, n_max) float32 linear terms at first coverage


class MergeResult(NamedTuple):
    """One sweep's result; a sweep of several stripes gives each field a
    leading (S,) axis."""

    assignment: torch.Tensor  # (V,) int8 best global assignment
    cut_value: torch.Tensor  # scalar f32
    beam_assign: torch.Tensor  # (W, V_pad) final frontier
    beam_score: torch.Tensor  # (W,)


def build_merge_plan(part: Partition, bitstring_indices: np.ndarray, k: int,
                     linear=None, device="cpu") -> MergePlan:
    """Bucket edges by level and unpack candidate indices to bit arrays.

    bitstring_indices: (M, K) basis indices from the QAOA solver (bit q of
    subgraph i's index = its local vertex q). ``linear`` (V,) f32 buckets
    each vertex's term on its first-coverage level, as edges are.
    Host-side numpy, equal element for element to the JAX plan.
    """
    g = part.graph
    m = part.m
    n_max = max(part.sizes)
    lo = np.asarray([r[0] for r in part.ranges], dtype=np.int32)
    hi = np.asarray([r[1] for r in part.ranges], dtype=np.int32)

    # first-coverage level per vertex: ranges are contiguous and sorted
    cover = np.minimum(np.searchsorted(hi, np.arange(g.n), side="right"),
                       m - 1).astype(np.int32)

    e = np.asarray(g.edges)[: g.n_edges]
    w = np.asarray(g.weights)[: g.n_edges]
    cu, cv = cover[e[:, 0]], cover[e[:, 1]]
    level = np.maximum(cu, cv)
    swap = cu > cv  # order endpoints: u = earlier-covered, v = later
    eu = np.where(swap, e[:, 1], e[:, 0])
    ev = np.where(swap, e[:, 0], e[:, 1])

    counts = np.bincount(level, minlength=m)
    e_lv = max(int(counts.max()) if counts.size else 1, 1)
    edge_u = np.zeros((m, e_lv), dtype=np.int32)
    edge_v = np.zeros((m, e_lv), dtype=np.int32)
    edge_w = np.zeros((m, e_lv), dtype=np.float32)
    fill = np.zeros(m, dtype=np.int64)
    for idx in np.argsort(level, kind="stable"):
        l = level[idx]
        edge_u[l, fill[l]] = eu[idx]
        edge_v[l, fill[l]] = ev[idx]
        edge_w[l, fill[l]] = w[idx]
        fill[l] += 1
    # padding rows have weight 0 and point at lo, inside the level's window
    for l in range(m):
        edge_u[l, fill[l]:] = lo[l]
        edge_v[l, fill[l]:] = lo[l]

    bits = ((np.asarray(bitstring_indices, dtype=np.int64)[:, :, None]
             >> np.arange(n_max, dtype=np.int64)) & 1).astype(np.int8)

    lin_arr = np.zeros((m, n_max), dtype=np.float32)
    if linear is not None:
        lin_np = np.asarray(linear, dtype=np.float32)
        assert lin_np.shape == (g.n,), (lin_np.shape, g.n)
        verts = np.arange(g.n)
        lin_arr[cover, verts - lo[cover]] = lin_np

    def dev(a):
        return torch.as_tensor(a, device=device)

    return MergePlan(n_vert=g.n, n_pad=g.n + n_max, n_max=n_max, k=k,
                     lo=dev(lo), cand_bits=dev(bits), edge_u=dev(edge_u),
                     edge_v=dev(edge_v), edge_w=dev(edge_w), lin=dev(lin_arr))


def _level_delta(beam_assign, oriented, lo: int, edge_u, edge_v, edge_w,
                 n_max: int, lin):
    """Score of this level's edge and linear buckets: (S, W, K) f32.

    beam_assign (S, W, V_pad) int8; oriented (S, W, K, n_max) int8. The
    linear term is scored on the oriented bits, which is where the two
    orientations of a candidate pick up different Σ h_v·x_v.
    """
    v_local = torch.clamp(edge_v - lo, 0, n_max - 1).long()
    u_local = torch.clamp(edge_u - lo, 0, n_max - 1).long()
    u_in_prefix = edge_u < lo
    s_u_prefix = beam_assign[..., edge_u.long()]  # (S, W, E)
    s_u_cand = oriented[..., u_local]  # (S, W, K, E)
    s_v = oriented[..., v_local]
    s_u = torch.where(u_in_prefix, s_u_prefix[:, :, None, :], s_u_cand)
    crossed = (s_u ^ s_v).to(torch.float32)
    return crossed @ edge_w + oriented.to(torch.float32) @ lin


def _seed_frontier(plan: MergePlan, w_width: int, lo_h: np.ndarray):
    """Level-0 frontier: both orientations of subgraph 1's K candidates,
    scored on the level-0 bucket; (W, V_pad) and (W,)."""
    k = plan.k
    dev = plan.cand_bits.device
    bits0 = plan.cand_bits[0]
    cands0 = torch.cat([bits0, 1 - bits0], dim=0)  # (2K, n_max)
    lo0 = int(lo_h[0])
    assign0 = torch.zeros((2 * k, plan.n_pad), dtype=torch.int8, device=dev)
    assign0[:, lo0:lo0 + plan.n_max] = cands0
    delta0 = _level_delta(assign0[None], cands0[None, :, None, :], lo0,
                          plan.edge_u[0], plan.edge_v[0], plan.edge_w[0],
                          plan.n_max, plan.lin[0])[0, :, 0]
    if 2 * k > w_width:
        top_v, top_i = stable_topk(delta0, w_width)
        return assign0[top_i], top_v
    beam_assign = torch.zeros((w_width, plan.n_pad), dtype=torch.int8,
                              device=dev)
    beam_score = torch.full((w_width,), NEG, dtype=torch.float32, device=dev)
    beam_assign[:2 * k] = assign0
    beam_score[:2 * k] = delta0
    return beam_assign, beam_score


def _level_step(beam_assign, beam_score, lo: int, bits, eu, ev, ew, lin, *,
                k: int, n_max: int, w_width: int, keep=None):
    """One merge level of S beams (S, W, ·): orient, score, keep the top
    ``w_width`` of each, write the window. ``keep`` (S, W·K) bool masks
    the flat (row, candidate) indices a stripe may keep at its split."""
    shared = beam_assign[:, :, lo]  # (S, W)
    flip = bits[None, None, :, 0] ^ shared[:, :, None]  # (S, W, K) int8
    oriented = bits[None, None] ^ flip[..., None]  # (S, W, K, n_max) int8
    delta = _level_delta(beam_assign, oriented, lo, eu, ev, ew, n_max, lin)
    flat = (beam_score[:, :, None] + delta).flatten(1)  # empty rows stay at NEG
    if keep is not None:
        flat = torch.where(keep, flat, NEG)
    top_v, top_i = stable_topk(flat, w_width)  # (S, W)
    s_idx = torch.arange(flat.shape[0], device=flat.device)[:, None]
    w_idx = torch.div(top_i, k, rounding_mode="floor")
    k_idx = top_i % k
    new_assign = beam_assign[s_idx, w_idx]
    picked = oriented[s_idx, w_idx, k_idx]  # (S, W, n_max)
    cur = new_assign[:, :, lo:lo + n_max]
    new_assign[:, :, lo:lo + n_max] = torch.where(top_v[..., None] > NEG / 2,
                                                  picked, cur)
    return new_assign, top_v


def _stripe_mask(ids: torch.Tensor, width: int, n_shards: int) -> torch.Tensor:
    """(S, width) bool: flat index j belongs to stripe ids[s] iff
    j mod n_shards == ids[s] (``merge.py:255-257``, ``:295-297``)."""
    j = torch.arange(width, device=ids.device)
    return (j % n_shards)[None, :] == ids[:, None]


def merge_scan(plan: MergePlan, beam_width: int, shard_id=None,
               n_shards: int = 1, split_level: int = 1) -> MergeResult:
    """Run the level-synchronous merge. Exact iff beam_width >= 2·K^M.

    With ``n_shards`` > 1 the frontier is striped at ``split_level``
    (paper §3.4.2): stripe s keeps the rows whose flat index is s mod
    ``n_shards`` there and sweeps them alone, as the paper's 2K^L DFS
    workers. ``shard_id`` is None (no stripe), an int (that stripe, as the
    JAX ``merge_scan``), or a 1-D tensor of stripe ids, swept together on
    a leading axis of the beam; the result's fields then carry that axis.
    """
    lo_h = plan.lo.cpu().numpy()
    dev = plan.cand_bits.device
    stripe = shard_id is not None and n_shards > 1
    ids = torch.as_tensor(0 if shard_id is None else shard_id,
                          dtype=torch.int64, device=dev)
    batched = ids.dim() == 1
    ids = ids.reshape(-1)
    seed_assign, seed_score = _seed_frontier(plan, beam_width, lo_h)
    n = ids.shape[0]
    beam_assign = seed_assign.expand(n, *seed_assign.shape).contiguous()
    beam_score = seed_score.expand(n, -1).contiguous()
    if stripe and split_level == 0:
        beam_score = torch.where(
            _stripe_mask(ids, beam_score.shape[1], n_shards), beam_score, NEG)
    for l in range(1, lo_h.shape[0]):
        keep = None
        if stripe and l == split_level:
            keep = _stripe_mask(ids, beam_score.shape[1] * plan.k, n_shards)
        beam_assign, beam_score = _level_step(
            beam_assign, beam_score, int(lo_h[l]), plan.cand_bits[l],
            plan.edge_u[l], plan.edge_v[l], plan.edge_w[l], plan.lin[l],
            k=plan.k, n_max=plan.n_max, w_width=beam_width, keep=keep)
    rows = torch.arange(n, device=dev)
    best = torch.argmax(beam_score, dim=1)  # first maximum, as jnp.argmax
    res = MergeResult(assignment=beam_assign[rows, best, : plan.n_vert],
                      cut_value=beam_score[rows, best], beam_assign=beam_assign,
                      beam_score=beam_score)
    return res if batched else MergeResult(*(x[0] for x in res))


class AnytimeSnapshot(NamedTuple):
    """One anytime-merge update: the best-known *complete* assignment after
    a merge level, with the suffix vertices filled greedily."""

    level: int  # levels merged so far (1..M)
    n_levels: int  # M
    cut_value: float  # objective of `assignment` on the full graph
    assignment: np.ndarray  # (V,) int8 complete assignment
    is_final: bool  # True on the last level (beam fully merged)


def _complete_suffix(plan_host, assign_pad: np.ndarray, level: int) -> np.ndarray:
    """Fill levels (level+1..M-1) of a partial assignment with each
    subgraph's top-1 candidate, oriented to agree on the shared vertex:
    the greedy completion that turns a frontier row into a full cut."""
    lo, cand_bits, n_max = plan_host
    a = assign_pad.copy()
    for j in range(level + 1, lo.shape[0]):
        bits = cand_bits[j, 0]  # (n_max,) top-1 candidate
        flip = np.int8(bits[0] ^ a[lo[j]])
        a[lo[j]: lo[j] + n_max] = bits ^ flip
    return a


def merge_stream(plan: MergePlan, beam_width: int) -> Iterator[AnytimeSnapshot]:
    """Anytime form of `merge_scan`: yield the best-known complete cut
    after every merge level (``merge.py:404-448`` of the reference).

    Runs the same `_level_step` recurrence as `merge_scan`, one level a
    call, so the caller can take an early answer between levels. After
    level l the best frontier row covers vertices [0, hi_l); the remaining
    subgraphs are completed greedily with their top-1 candidates (oriented
    at the shared vertex), and the cut is scored on the host from the
    plan's edge buckets (every edge and linear term lies in exactly one).
    The final snapshot's frontier is the fully merged beam. Each level's
    ``merge_level`` span closes before its snapshot is yielded: a consumer
    may hold the generator between yields, and that wait is not the
    merge's.
    """
    m = int(plan.lo.shape[0])
    lo_h = plan.lo.cpu().numpy()
    bits_h = plan.cand_bits.cpu().numpy()
    eu_h, ev_h = plan.edge_u.cpu().numpy(), plan.edge_v.cpu().numpy()
    ew_h, lin_h = plan.edge_w.cpu().numpy(), plan.lin.cpu().numpy()
    plan_host = (lo_h, bits_h, plan.n_max)
    beam_assign, beam_score = _seed_frontier(plan, beam_width, lo_h)
    beam_assign, beam_score = beam_assign[None], beam_score[None]

    def snapshot(level: int) -> AnytimeSnapshot:
        best = int(np.argmax(beam_score[0].cpu().numpy()))
        partial = beam_assign[0, best].cpu().numpy()
        full = _complete_suffix(plan_host, partial, level)
        crossed = (full[eu_h] ^ full[ev_h]).astype(np.float32)
        cut = float(np.sum(crossed * ew_h))
        for l in range(m):
            win = full[lo_h[l]: lo_h[l] + plan.n_max].astype(np.float32)
            cut += float(lin_h[l] @ win)
        return AnytimeSnapshot(level=level + 1, n_levels=m, cut_value=cut,
                               assignment=full[: plan.n_vert],
                               is_final=level == m - 1)

    tr = trace_mod.get_tracer()
    with tr.span("merge_level", level=1, n_levels=m):
        snap = snapshot(0)
    yield snap
    for l in range(1, m):
        with tr.span("merge_level", level=l + 1, n_levels=m):
            beam_assign, beam_score = _level_step(
                beam_assign, beam_score, int(lo_h[l]), plan.cand_bits[l],
                plan.edge_u[l], plan.edge_v[l], plan.edge_w[l], plan.lin[l],
                k=plan.k, n_max=plan.n_max, w_width=beam_width)
            snap = snapshot(l)
        yield snap


def global_winner(res: MergeResult, axis, shard_id: torch.Tensor):
    """The winner of a striped merge over ``axis`` (``merge.py:451-464``):
    the best value is the max over shards; among shards that reach it the
    lowest wins, and its assignment is broadcast. ``res`` carries a
    leading axis of this process's stripes, ``shard_id`` (local,) their
    ids. Returns (assignment (V,) int8, value), the same on every process.
    The rank and the assignment reduce in int64 and int32: NCCL and gloo
    need not reduce int8 alike."""
    best = axis.max(res.cut_value)
    rank = torch.where(res.cut_value >= best, shard_id, 2**30)
    winner = axis.min(rank)
    mine = (shard_id == winner).to(torch.int32)
    assign = axis.sum(res.assignment.to(torch.int32) * mine[:, None])[0]
    return assign.to(torch.int8), best


def exact_beam_width(k: int, m: int, cap: int = 1 << 22) -> int:
    """Frontier size that makes `merge_scan` exhaustive: 2·K^M (capped)."""
    w = 2
    for _ in range(m):
        w *= k
        if w > cap:
            return cap
    return max(w, 2 * k)


def striped_beam_width(k: int, m: int, n_shards: int, split_level: int,
                       cap: int = 1 << 22) -> int | None:
    """Per-shard frontier width that keeps a striped merge exhaustive (a
    copy of ``merge.py:477-500``).

    Before the split every shard carries the full frontier (2·K^j rows
    survive level j, so the width must reach 2·K^split); after it each
    stripe grows by K a level, and pruning at the last level is harmless.
    None when the exhaustive sweep (global 2·K^M, or the per-shard share)
    exceeds ``cap``: the merge is then heuristic.
    """
    total = 2 * k**m
    if total > cap:
        return None
    l = min(split_level, m - 1)
    roots = -(-2 * k**l // n_shards)
    w = max(roots * k ** (m - 1 - l), 2 * k**l, 2 * k)
    return w if w <= cap else None
