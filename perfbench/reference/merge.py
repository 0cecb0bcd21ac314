"""The paper's level-aware merge (Alg. 2) as a beam search, written from its
definition, with scores in float64.

Level 0 holds both orientations of the first range's K candidates: the
candidates, then their complements. Level l extends every kept row by each
of range l's K candidates, flipped where needed so that the vertex range l
shares with range l − 1 keeps its value, and adds the weight of the edges
that become decided: those whose higher end is a fresh vertex of range l.
The best ``width`` extensions are kept, ties to the lower (row · K + k).
The answer is the first best row after the last level. With width ≥ 2·K^M
nothing is pruned.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_CHUNK = 1 << 25  # (row, candidate, edge) triples scored at once


def _bits(index: int, width: int) -> np.ndarray:
    return ((int(index) >> np.arange(width)) & 1).astype(np.int8)


def merge(n: int, edges: np.ndarray, weights: np.ndarray, rngs, candidates,
          width: int, device="cpu") -> tuple[np.ndarray, float]:
    """(assignment (n,) int8, score) of the merge of ``candidates`` (M, K),
    basis indices whose bit q is vertex lo + q of their range."""
    m = len(rngs)
    k = np.asarray(candidates).shape[1]
    hi = np.asarray([b for _, b in rngs])
    first = np.minimum(np.searchsorted(hi, np.arange(n), side="right"), m - 1)
    level = first[edges[:, 1]]  # u < v, so v is decided last
    order = np.argsort(level, kind="stable")
    starts = np.searchsorted(level[order], np.arange(m + 1))
    e_dev = torch.as_tensor(edges[order].astype(np.int64), device=device)
    w_dev = torch.as_tensor(weights[order].astype(np.float64), device=device)

    def level_edges(l):
        a, b = starts[l], starts[l + 1]
        return e_dev[a:b, 0], e_dev[a:b, 1], w_dev[a:b]

    lo0, hi0 = rngs[0]
    c0 = np.stack([_bits(c, hi0 - lo0) for c in candidates[0]])
    rows = np.concatenate([c0, 1 - c0])  # (2K, n0)
    assign = torch.zeros((2 * k, n), dtype=torch.int8, device=device)
    assign[:, lo0:hi0] = torch.as_tensor(rows, device=device)
    u, v, w = level_edges(0)
    score = ((assign[:, u] != assign[:, v]).double() @ w)
    if 2 * k > width:
        keep = _top(score, width)
        assign, score = assign[keep], score[keep]

    for l in range(1, m):
        lo, h = rngs[l]
        cand = torch.as_tensor(np.stack([_bits(c, h - lo) for c in candidates[l]]),
                               device=device)  # (K, n_l)
        shared = assign[:, lo]  # (R,)
        flip = cand[None, :, 0] ^ shared[:, None]  # (R, K)
        window = cand[None] ^ flip[..., None]  # (R, K, n_l)
        u, v, w = level_edges(l)
        r = assign.shape[0]
        in_window = (u >= lo)[None, None, :]
        u_win, v_win = (u - lo).clamp(min=0), v - lo
        gain = torch.empty((r, k), dtype=torch.float64, device=device)
        step = max(1, ROW_CHUNK // max(1, k * u.numel()))
        for a in range(0, r, step):
            win = window[a:a + step]
            xu = torch.where(in_window, win[:, :, u_win], assign[a:a + step, u][:, None, :])
            gain[a:a + step] = (xu != win[:, :, v_win]).double() @ w
        flat = (score[:, None] + gain).reshape(-1)  # (R·K,)
        keep = _top(flat, min(width, r * k))
        row, kk = keep // k, keep % k
        assign = assign[row]
        assign[:, lo:h] = window[row, kk]
        score = flat[keep]
    best = int(torch.argmax(score))
    return assign[best].cpu().numpy(), float(score[best])


def _top(score: torch.Tensor, count: int) -> torch.Tensor:
    """Indices of the ``count`` largest scores, ties to the lower index."""
    return torch.sort(score, descending=True, stable=True).indices[:count]
