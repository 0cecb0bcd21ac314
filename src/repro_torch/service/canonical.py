"""Canonical graph hashing for the result cache (a copy of
``repro/service/canonical.py``, which is numpy-only: the port imports
nothing of the JAX package, and the keys must be the reference's bytes).

Two `Graph` instances that differ only by edge-list padding, edge order,
duplicate/zero-weight edges, or a vertex relabeling should map to the same
cache key. The canonical form is a degree-ordered relabeling computed by
Weisfeiler-Leman color refinement over the weighted adjacency structure,
followed by bounded individualization when refinement leaves ties:

  1. normalize the edge list (strip padding rows via ``n_edges``, drop
     self-loops and zero-weight edges, orient u < v, coalesce parallel
     edges by summing weights) — this is what makes the key
     padding-invariant;
  2. refine vertex colors to a stable partition, where a vertex's
     signature is (its color, the sorted multiset of (edge weight,
     neighbor color)) — signatures are ranked by sorted order, so the
     refinement is relabeling-invariant by construction;
  3. while non-singleton color classes remain, individualize the first
     vertex of the smallest-rank class and re-refine. When the tied
     vertices are automorphic (the overwhelmingly common case on the
     random weighted instances this service sees) every choice yields the
     identical certificate; WL-equivalent non-automorphic ties (e.g.
     strongly regular graphs) can split isomorphic inputs into different
     keys — a cache *miss*, never a wrong answer, because the cache
     re-scores every hit against the querying graph.

The certificate hashed is (n, sorted relabeled weighted edge list), via
sha256. `CanonicalForm.perm` maps original vertex → canonical index, which
is what lets the cache store assignments in canonical vertex order and
replay them onto any relabeled instance.

Above `_EXACT_THRESHOLD` vertices, steps 2-3 switch to a vectorized
64-bit multiset-hash refinement without individualization — O(|E|) numpy
work per round on the admission path instead of per-vertex Python tuple
sorting; hash collisions or residual ties only weaken the key (a miss),
never the answer.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from repro_torch.core.graph import Graph, Problem


_MAX_INDIVIDUALIZE = 64


class CanonicalForm(NamedTuple):
    key: str  # sha256 hex digest of the canonical certificate
    perm: np.ndarray  # (n,) int32: original vertex -> canonical index
    n: int
    n_edges: int  # normalized (deduplicated) edge count


def normalized_edges(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Padding-free, order-free edge list: (E, 2) with u < v, coalesced."""
    e = np.asarray(graph.edges)[: graph.n_edges].astype(np.int64)
    w = np.asarray(graph.weights)[: graph.n_edges].astype(np.float64)
    live = (e[:, 0] != e[:, 1]) & (w != 0.0)
    e, w = e[live], w[live]
    u = np.minimum(e[:, 0], e[:, 1])
    v = np.maximum(e[:, 0], e[:, 1])
    # coalesce parallel edges: sum weights per (u, v) pair
    flat = u * graph.n + v
    order = np.argsort(flat, kind="stable")
    flat, u, v, w = flat[order], u[order], v[order], w[order]
    uniq, start = np.unique(flat, return_index=True)
    wsum = np.add.reduceat(w, start) if w.size else w
    uv = np.stack([uniq // graph.n, uniq % graph.n], axis=1)
    keep = wsum != 0.0  # coalesced ±w pairs cancel
    return uv[keep].astype(np.int64), wsum[keep].astype(np.float64)


# above this vertex count, refinement switches to the vectorized hashed
# form and skips individualization: admission-path latency stays O(|E|)
# numpy work instead of per-vertex Python tuple sorting
_EXACT_THRESHOLD = 256


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (wrapping arithmetic)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _refine_hashed(
    n: int, uv: np.ndarray, w: np.ndarray, colors: np.ndarray
) -> np.ndarray:
    """Vectorized WL refinement for large graphs.

    A vertex's signature is a 64-bit multiset hash: the sum (wrapping,
    hence order-free) of mixed (neighbor color, edge weight) contributions,
    combined with its own color. Ranks come from `np.unique`'s sort of the
    signature *values*, so the result is relabeling-invariant up to hash
    collisions — which only coarsen the partition and weaken the cache
    key; the cache's re-score-on-hit keeps that safe.
    """
    eu, ev = uv[:, 0].astype(np.int64), uv[:, 1].astype(np.int64)
    w_q = _mix64(np.round(w * 1e6).astype(np.int64).astype(np.uint64))
    n_colors = len(np.unique(colors))
    while True:
        hc = _mix64(colors.astype(np.uint64))
        acc = np.zeros(n, dtype=np.uint64)
        np.add.at(acc, eu, _mix64(hc[ev] ^ w_q))
        np.add.at(acc, ev, _mix64(hc[eu] ^ w_q))
        _, colors = np.unique(_mix64(hc ^ acc), return_inverse=True)
        if len(np.unique(colors)) == n_colors:
            return colors
        n_colors = len(np.unique(colors))


def _refine(n: int, adj: list, colors: np.ndarray) -> np.ndarray:
    """WL color refinement to a fixed point. Signature ranks are assigned
    by sorted signature order, so the result is relabeling-invariant."""
    n_colors = len(np.unique(colors))
    while True:
        sigs = []
        for vtx in range(n):
            nbr = tuple(sorted((wt, int(colors[o])) for o, wt in adj[vtx]))
            sigs.append((int(colors[vtx]), nbr))
        ranked = {s: i for i, s in enumerate(sorted(set(sigs)))}
        colors = np.asarray([ranked[s] for s in sigs], dtype=np.int64)
        if len(ranked) == n_colors:
            return colors
        n_colors = len(ranked)


def canonical_form(graph: Graph | Problem) -> CanonicalForm:
    """Compute the canonical relabeling + cache key of a graph or problem.

    A `Problem`'s linear terms and offset fold into the key: initial WL
    colors come from the ranks of the (quantized) per-vertex linear
    coefficients — relabeling-invariant, since ranks depend only on
    values — and the certificate appends the relabeled linear vector and
    the offset. Two QUBOs sharing a quadratic but differing in linear
    terms therefore cannot collide. Both additions are gated on the terms
    being nonzero, so a plain `Graph` (and the zero-linear `Problem`)
    hashes to the byte-identical pre-QUBO key.
    """
    lin = None
    offset = 0.0
    if isinstance(graph, Problem):
        prob = graph
        graph = prob.graph
        lin_arr = np.asarray(prob.linear, dtype=np.float64)
        offset = float(prob.offset)
        if np.any(lin_arr != 0.0):
            lin = lin_arr
    n = graph.n
    uv, w = normalized_edges(graph)

    colors0 = np.zeros(n, dtype=np.int64)
    if lin is not None:
        # rank-of-value initial coloring: vertices with distinct linear
        # coefficients can never be confused, and the refinement keeps
        # its relabeling invariance (ranks are label-free)
        _, colors0 = np.unique(np.round(lin * 1e6).astype(np.int64),
                               return_inverse=True)
        colors0 = colors0.astype(np.int64)

    if n > _EXACT_THRESHOLD:
        # large graphs: vectorized hashed refinement, no individualization
        # (admission latency over key strength; misses stay correct)
        colors = _refine_hashed(n, uv, w, colors0)
    else:
        adj: list = [[] for _ in range(n)]
        for (u, v), wt in zip(uv, w.round(9)):
            adj[u].append((v, float(wt)))
            adj[v].append((u, float(wt)))

        colors = _refine(n, adj, colors0)
        # individualization: split remaining ties one vertex at a time.
        # Pick the lowest-index vertex of the smallest-rank non-singleton
        # class — deterministic, and certificate-invariant whenever the
        # tie is an automorphism (any member gives the same canonical
        # graph). Bounded: residual ties fall through to the argsort's
        # stable index tie-break — a weaker, best-effort key that can
        # only cost cache hits, not correctness (the cache re-scores
        # every hit).
        rounds = 0
        while len(np.unique(colors)) < n and rounds < _MAX_INDIVIDUALIZE:
            counts = np.bincount(colors)
            cls = int(np.flatnonzero(counts > 1)[0])
            pick = int(np.flatnonzero(colors == cls)[0])
            colors = colors * 2
            colors[pick] -= 1
            colors = _refine(n, adj, colors)
            rounds += 1

    # colors are now a permutation rank (up to residual ties, broken by
    # original index via the stable sort); perm[orig] = canonical index
    perm = np.empty(n, dtype=np.int32)
    perm[np.argsort(colors, kind="stable")] = np.arange(n, dtype=np.int32)

    cu = perm[uv[:, 0]]
    cv = perm[uv[:, 1]]
    lo = np.minimum(cu, cv)
    hi = np.maximum(cu, cv)
    order = np.lexsort((hi, lo))
    cert = hashlib.sha256()
    cert.update(np.int64(n).tobytes())
    cert.update(lo[order].astype(np.int64).tobytes())
    cert.update(hi[order].astype(np.int64).tobytes())
    cert.update(w[order].round(6).astype(np.float64).tobytes())
    if lin is not None:
        # linear terms in *canonical* vertex order + the constant offset;
        # appended only when nonzero so the zero path stays byte-identical
        lin_canon = np.empty(n, dtype=np.float64)
        lin_canon[perm] = lin
        cert.update(b"lin")
        cert.update(lin_canon.round(6).tobytes())
        cert.update(np.float64(offset).tobytes())
    return CanonicalForm(
        key=cert.hexdigest(), perm=perm, n=n, n_edges=int(uv.shape[0])
    )


def canonical_key(graph: Graph | Problem) -> str:
    return canonical_form(graph).key
