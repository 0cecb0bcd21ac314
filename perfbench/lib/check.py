"""Whether what the window produced is correct: every solve's partition,
merge, refinement and reported value, and the QAOA stage of rows drawn
from the seed, each against the plain reference (``perfbench/reference``).

Numbers compared, each with the limit the cell's file gives:
  partition_diff  ranges, inside-edge lists and the cross-edge list that
                  differ from the reference's partition, over all solves;
  qaoa_exp_err    the largest |⟨C⟩ − ⟨C⟩_ref| / Σ|w| of a drawn row,
                  ⟨C⟩_ref after the reference's own Adam ascent in float64;
  qaoa_prob_err   the largest gap, over a drawn row's K candidates, between
                  a candidate's reported probability and the reference's
                  for it, or between the reference's k-th largest
                  probability and the k-th of the candidates', over the
                  reference's largest;
  merge_diff      vertices on which a solve's answer differs from the
                  reference's merge and refinement of that solve's own
                  candidates, over all solves;
  value_diff      the largest |reported value − the answer's cut|;
  qaoa_missing    solves whose QAOA stage the harness could not read
                  (`bench.stage_of`), limit 0: the QAOA numbers are taken
                  over the rows of the other solves.
The merge is followed from the solver's candidates: the QAOA stage that
this skips is judged by itself, on the drawn rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.lib.generate import rng_for
from perfbench.reference import merge as ref_merge
from perfbench.reference import partition as ref_part
from perfbench.reference import qaoa as ref_qaoa
from perfbench.reference import refine as ref_refine

NAMES = ("partition_diff", "qaoa_exp_err", "qaoa_prob_err", "merge_diff", "value_diff",
         "qaoa_missing")
EXACT_LIMITS = {"qaoa_missing": 0}  # fixed: a cell does not set them
REF_AMPLITUDES = 1 << 26  # amplitudes of the rows the reference runs at once


@dataclasses.dataclass
class Solved:
    """What one solve of the window returned, on the host, beside the
    instance it was given."""

    n: int
    edges: np.ndarray  # (m, 2) int32, u < v
    weights: np.ndarray  # (m,) float32
    assignment: np.ndarray  # (n,) int8
    value: float  # the value the solver reported
    ranges: list  # the solver's partition
    sub_edges: list  # per range: (e_i, 2) local edges
    sub_weights: list  # per range: (e_i,) weights
    cross_edges: np.ndarray
    cross_weights: np.ndarray
    candidates: np.ndarray  # (M, K) basis indices
    probs: np.ndarray | None  # (M, K) reported marginal probabilities
    expectation: np.ndarray | None  # (M,) reported ⟨C⟩; both None without the stage


def cut(edges: np.ndarray, weights: np.ndarray, x) -> float:
    x = np.asarray(x)
    return float(np.sum(weights.astype(np.float64) * (x[edges[:, 0]] != x[edges[:, 1]])))


def beam_width(cfg: dict, m: int) -> int:
    """The merge's beam: the configured width, else 2·K^M up to the cap."""
    if cfg.get("beam_width"):
        return int(cfg["beam_width"])
    w = 2
    for _ in range(m):
        w *= cfg["top_k"]
        if w > cfg["beam_cap"]:
            return int(cfg["beam_cap"])
    return max(w, 2 * cfg["top_k"])


def partition_diff(s: Solved, n_qubits: int) -> tuple[int, list, np.ndarray]:
    """(differences, the reference's ranges, each edge's range or −1)."""
    rngs = ref_part.ranges(s.n, ref_part.n_ranges(s.n, n_qubits))
    where = ref_part.split_edges(s.edges, rngs)
    diff = 0 if [tuple(r) for r in s.ranges] == rngs else 1 + abs(len(s.ranges) - len(rngs))
    if len(s.ranges) == len(rngs):
        order = np.argsort(where, kind="stable")
        bounds = np.searchsorted(where[order], np.arange(-1, len(rngs) + 1))
        for i, (lo, _) in enumerate(rngs):
            idx = order[bounds[i + 1]:bounds[i + 2]]
            if not (np.array_equal(s.sub_edges[i], s.edges[idx] - lo)
                    and np.array_equal(s.sub_weights[i], s.weights[idx])):
                diff += 1
        cross = order[bounds[0]:bounds[1]]
        if not (np.array_equal(s.cross_edges, s.edges[cross])
                and np.array_equal(s.cross_weights, s.weights[cross])):
            diff += 1
    return diff, rngs, where


def draw_rows(seed: int, rows_per_solve: list[int], count: int) -> list[tuple[int, int]]:
    """``count`` distinct (solve, row) pairs of the window, drawn from the
    seed: every row when there are no more than ``count``, else one row
    from each of ``count`` equal spans of a batch's row positions, in a
    solve drawn for each span. So the first rows of a batch and its last
    are both drawn, however few rows are: a batch solved only in part
    cannot hide in the rows that were not drawn."""
    pairs = [(i, r) for i, m in enumerate(rows_per_solve) for r in range(m)]
    if count >= len(pairs):
        return pairs
    rng = rng_for(seed, 2)
    drawn = set()
    for j in range(count):
        i = int(rng.integers(len(rows_per_solve)))
        m = rows_per_solve[i]
        lo = min(j * m // count, m - 1)
        hi = max(lo + 1, (j + 1) * m // count)
        drawn.add((i, int(rng.integers(lo, hi))))
    return sorted(drawn)


def qaoa_reference(cfg: dict, n_sub: int, edges_l, weights_l, precision, device):
    """(cut tables, probabilities) of subgraphs of ``n_sub`` vertices."""
    e_pad = max(1, max(len(e) for e in edges_l))
    e = np.zeros((len(edges_l), e_pad, 2), dtype=np.int64)
    w = np.zeros((len(edges_l), e_pad), dtype=np.float64)
    for i, (ei, wi) in enumerate(zip(edges_l, weights_l)):
        e[i, :len(ei)], w[i, :len(wi)] = ei, wi
    return ref_qaoa.solve_rows(n_sub, e, w, p=cfg["p_layers"], steps=cfg["opt_steps"],
                               lr=cfg["learning_rate"], delta=cfg["ramp_delta"],
                               precision=precision, device=device)


def qaoa_errors(c, probs_ref, candidates, probs, expectation, abs_w):
    """(exp_err, prob_err) of one row, as the module's docstring says."""
    p = probs_ref.to(torch.float64)
    e_ref = float(torch.sum(p * c.to(torch.float64)))
    exp_err = abs(float(expectation) - e_ref) / max(abs_w, 1.0)
    cand = torch.as_tensor(np.asarray(candidates, dtype=np.int64), device=p.device)
    if bool(((cand < 0) | (cand >= p.numel())).any()):  # not a state of this subgraph
        return exp_err, float("inf")
    at_cand = p[cand]
    top = torch.sort(p, descending=True).values[: cand.numel()]
    ranked = torch.sort(at_cand, descending=True).values
    reported = torch.as_tensor(np.asarray(probs, dtype=np.float64), device=p.device)
    gap = torch.maximum(torch.abs(reported - at_cand).max(), (top - ranked).max())
    return exp_err, float(gap / top[0])


def check(cfg: dict, limits: dict, qaoa_rows: int, solved: list[Solved], seed: int,
          device) -> list[tuple[str, float, float]]:
    """[(name, number, limit)] over the window's solves."""
    nums, plans = exact_numbers(cfg, solved, device)
    staged = [j for j, s in enumerate(solved) if s.probs is not None]
    nums["qaoa_missing"] = len(solved) - len(staged)
    nums.update(qaoa_numbers(cfg, [solved[j] for j in staged], [plans[j] for j in staged],
                             seed, qaoa_rows, device)["solver"])
    limits = {**limits, **EXACT_LIMITS}
    return [(k, float(nums[k]), float(limits[k])) for k in NAMES]


def exact_numbers(cfg: dict, solved: list[Solved], device):
    """(partition_diff, merge_diff and value_diff over all solves; each
    solve's reference partition)."""
    nums = {"partition_diff": 0, "merge_diff": 0, "value_diff": 0.0}
    plans = []
    for s in solved:
        d, rngs, where = partition_diff(s, cfg["n_qubits"])
        nums["partition_diff"] += d
        plans.append((rngs, where))
        merged, _ = ref_merge.merge(s.n, s.edges, s.weights, rngs, s.candidates,
                                    beam_width(cfg, len(rngs)), device=device)
        answer = ref_refine.refine(s.n, s.edges, s.weights, merged, cfg["refine_steps"])
        nums["merge_diff"] += int(np.sum(answer != s.assignment))
        nums["value_diff"] = max(nums["value_diff"],
                                 abs(s.value - cut(s.edges, s.weights, s.assignment)))
    return nums, plans


def qaoa_numbers(cfg: dict, solved: list[Solved], plans, seed: int, qaoa_rows: int, device,
                 control: bool = False) -> dict:
    """{"solver": {qaoa_exp_err, qaoa_prob_err}} over the rows drawn from the
    seed; with ``control``, also {"control": ...}: the same numbers of the
    reference in TF32 put in the solver's place on those rows."""
    out = {"solver": {"qaoa_exp_err": 0.0, "qaoa_prob_err": 0.0}}
    if control:
        out["control"] = {"qaoa_exp_err": 0.0, "qaoa_prob_err": 0.0}
    if not solved:
        return out
    k = solved[0].candidates.shape[1]
    pairs = draw_rows(seed, [len(s.candidates) for s in solved], qaoa_rows)
    for n_sub, items in _by_size(pairs, plans):
        edges_l, weights_l = [], []
        for i, r in items:
            (lo, _), where = plans[i][0][r], plans[i][1]
            idx = np.flatnonzero(where == r)
            edges_l.append(solved[i].edges[idx] - lo)
            weights_l.append(solved[i].weights[idx])
        c, pr = qaoa_reference(cfg, n_sub, edges_l, weights_l, "float64", device)
        answers = {"solver": [(solved[i].candidates[r], solved[i].probs[r],
                               solved[i].expectation[r]) for i, r in items]}
        if control:
            with ref_qaoa.tf32_products():
                c32, p32 = qaoa_reference(cfg, n_sub, edges_l, weights_l, "tf32", device)
            top = ref_qaoa.top_k(p32, k)
            answers["control"] = [(top[j].cpu().numpy(), p32[j, top[j]].cpu().numpy(),
                                   float(torch.sum(p32[j] * c32[j]))) for j in range(len(items))]
        for who, rows in answers.items():
            for j, (cand, probs, expectation) in enumerate(rows):
                exp_err, prob_err = qaoa_errors(c[j], pr[j], cand, probs, expectation,
                                                float(np.abs(weights_l[j]).sum()))
                nums = out[who]
                nums["qaoa_exp_err"] = max(nums["qaoa_exp_err"], exp_err)
                nums["qaoa_prob_err"] = max(nums["qaoa_prob_err"], prob_err)
    return out


def _by_size(pairs, plans):
    """Drawn (solve, row) pairs grouped by their range's size, the rows of
    one group run as one batch."""
    groups: dict[int, list] = {}
    for i, r in pairs:
        lo, hi = plans[i][0][r]
        groups.setdefault(hi - lo, []).append((i, r))
    for n_sub, items in sorted(groups.items()):
        step = max(1, REF_AMPLITUDES >> n_sub)
        for a in range(0, len(items), step):
            yield n_sub, items[a:a + step]
