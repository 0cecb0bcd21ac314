"""Level-Aware Parallel Merge, paper Alg. 2 (port of ``repro/core/merge.py``).

A level-synchronous frontier ("beam") of (partial global assignment,
partial score) rows is swept over the subgraph levels: level 0 seeds both
orientations of subgraph 1's K candidates; every later level extends each
row by the K candidates of its subgraph, oriented so the shared vertex
agrees (an int8 XOR flip), scores the level's bucket of original-graph
edges and linear terms incrementally, and keeps the best ``beam_width``
rows. With ``beam_width >= 2·K^M`` nothing is pruned and the sweep is the
paper's exhaustive search. Only the unstriped single-device sweep is
ported; the striped and streaming forms are on ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.partition import Partition
from repro_torch.core.engine import stable_topk

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
    """Score of this level's edge and linear buckets: (W, K) f32.

    beam_assign (W, V_pad) int8; oriented (W, K, n_max) int8. The linear
    term is scored on the oriented bits, which is where the two
    orientations of a candidate pick up different Σ h_v·x_v.
    """
    v_local = torch.clamp(edge_v - lo, 0, n_max - 1).long()
    u_local = torch.clamp(edge_u - lo, 0, n_max - 1).long()
    u_in_prefix = edge_u < lo
    s_u_prefix = beam_assign[:, edge_u.long()]  # (W, E)
    s_u_cand = oriented[:, :, u_local]  # (W, K, E)
    s_v = oriented[:, :, v_local]
    s_u = torch.where(u_in_prefix[None, None, :], s_u_prefix[:, None, :],
                      s_u_cand)
    crossed = (s_u ^ s_v).to(torch.float32)
    return crossed @ edge_w + oriented.to(torch.float32) @ lin


def _seed_frontier(plan: MergePlan, w_width: int, lo_h: np.ndarray):
    """Level-0 frontier: both orientations of subgraph 1's K candidates,
    scored on the level-0 bucket."""
    k = plan.k
    dev = plan.cand_bits.device
    bits0 = plan.cand_bits[0]
    cands0 = torch.cat([bits0, 1 - bits0], dim=0)  # (2K, n_max)
    lo0 = int(lo_h[0])
    assign0 = torch.zeros((2 * k, plan.n_pad), dtype=torch.int8, device=dev)
    assign0[:, lo0:lo0 + plan.n_max] = cands0
    delta0 = _level_delta(assign0, cands0[:, None, :], lo0, plan.edge_u[0],
                          plan.edge_v[0], plan.edge_w[0], plan.n_max,
                          plan.lin[0])[:, 0]
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
                k: int, n_max: int, w_width: int):
    """One merge level: orient, score, keep the top ``w_width``, write the
    window."""
    shared = beam_assign[:, lo]  # (W,)
    flip = bits[None, :, 0] ^ shared[:, None]  # (W, K) int8
    oriented = bits[None, :, :] ^ flip[:, :, None]  # (W, K, n_max) int8
    delta = _level_delta(beam_assign, oriented, lo, eu, ev, ew, n_max, lin)
    scores = beam_score[:, None] + delta  # empty rows stay at NEG
    top_v, top_i = stable_topk(scores.reshape(-1), w_width)
    w_idx = torch.div(top_i, k, rounding_mode="floor")
    k_idx = top_i % k
    new_assign = beam_assign[w_idx]
    picked = oriented[w_idx, k_idx]  # (W, n_max)
    cur = new_assign[:, lo:lo + n_max]
    new_assign[:, lo:lo + n_max] = torch.where(top_v[:, None] > NEG / 2,
                                               picked, cur)
    return new_assign, top_v


def merge_scan(plan: MergePlan, beam_width: int) -> MergeResult:
    """Run the level-synchronous merge. Exact iff beam_width >= 2·K^M."""
    lo_h = plan.lo.cpu().numpy()
    beam_assign, beam_score = _seed_frontier(plan, beam_width, lo_h)
    for l in range(1, lo_h.shape[0]):
        beam_assign, beam_score = _level_step(
            beam_assign, beam_score, int(lo_h[l]), plan.cand_bits[l],
            plan.edge_u[l], plan.edge_v[l], plan.edge_w[l], plan.lin[l],
            k=plan.k, n_max=plan.n_max, w_width=beam_width)
    best = torch.argmax(beam_score)  # first maximum, as jnp.argmax
    return MergeResult(assignment=beam_assign[best, : plan.n_vert],
                       cut_value=beam_score[best], beam_assign=beam_assign,
                       beam_score=beam_score)


def exact_beam_width(k: int, m: int, cap: int = 1 << 22) -> int:
    """Frontier size that makes `merge_scan` exhaustive: 2·K^M (capped)."""
    w = 2
    for _ in range(m):
        w *= k
        if w > cap:
            return cap
    return max(w, 2 * k)
