"""Canonical-graph result cache with LRU eviction (port of
``repro/service/cache.py``).

Entries are keyed on the canonical graph hash and store the best-known
assignment in *canonical vertex order*, so a hit replays onto any
relabeled-but-isomorphic instance through the querying graph's own
canonical permutation. Every hit is re-scored against the querying
graph/problem with the *full* objective (`problem_value` — quadratic +
linear + offset, O(|E| + n)) before being served: a hash collision or a
WL-equivalent non-isomorphic twin then degrades to a miss instead of a
wrong answer.

Entries also carry the quality score of the knob plan that produced them
(`planner.quality_score`): a request is only served from cache when the cached result
was computed at equal-or-better quality, so a tight-deadline/cheap-knob
result never masquerades as a high-accuracy one.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.graph import Graph, Problem, as_problem, problem_value
from repro_torch.service.canonical import CanonicalForm, canonical_form


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    quality_misses: int = 0  # key present but cached quality too low
    verify_failures: int = 0  # key matched, replayed cut did not
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "quality_misses": self.quality_misses,
            "verify_failures": self.verify_failures,
            "evictions": self.evictions,
            "hit_ratio": round(self.hit_ratio, 4),
        }


@dataclasses.dataclass
class _Entry:
    canon_assignment: np.ndarray  # (n,) int8, canonical vertex order
    cut: float
    quality: float  # planner quality score of the producing knobs


class ResultCache:
    """Bounded LRU map: canonical graph key → best-known cut."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(
        self,
        graph: Graph | Problem,
        form: CanonicalForm | None = None,
        min_quality: float = 0.0,
    ) -> tuple[np.ndarray, float] | None:
        """Return (assignment, value) replayed onto `graph`'s labels, or None.

        `min_quality` gates stale-quality hits; `form` skips recomputing
        the canonical form when the caller already has it. The hit is
        re-scored with the *full* objective of the querying problem
        (quadratic + linear + offset), not `cut_value` alone — two QUBOs
        differing only in linear terms hash differently, but the re-score
        guard must still catch any residual collision on the linear part.
        """
        prob = as_problem(graph)
        form = form or canonical_form(graph)
        entry = self._entries.get(form.key)
        if entry is None or entry.canon_assignment.shape[0] != prob.n:
            self.stats.misses += 1
            return None
        if entry.quality < min_quality:
            self.stats.misses += 1
            self.stats.quality_misses += 1
            return None
        assignment = entry.canon_assignment[form.perm]
        replayed = float(problem_value(prob, torch.as_tensor(assignment)))
        if abs(replayed - entry.cut) > 1e-2 * max(1.0, abs(entry.cut)):
            # collision / WL-twin: same key, different graph — refuse
            self.stats.misses += 1
            self.stats.verify_failures += 1
            return None
        self._entries.move_to_end(form.key)
        self.stats.hits += 1
        return assignment, replayed

    def store(
        self,
        graph: Graph | Problem,
        assignment: np.ndarray,
        cut: float,
        quality: float = 0.0,
        form: CanonicalForm | None = None,
    ) -> None:
        """Insert/upgrade the entry for `graph`. ``cut`` is the full
        objective value (for a `Problem`, including linear terms and
        offset). Keeps the better value at the higher quality mark; never
        downgrades an existing entry."""
        prob = as_problem(graph)
        form = form or canonical_form(graph)
        canon = np.empty(prob.n, dtype=np.int8)
        canon[form.perm] = np.asarray(assignment, dtype=np.int8)
        prev = self._entries.get(form.key)
        if prev is not None and prev.cut >= cut and prev.quality >= quality:
            self._entries.move_to_end(form.key)
            return
        if prev is not None and prev.cut > cut:
            canon, cut = prev.canon_assignment, prev.cut
        quality = max(quality, prev.quality if prev else quality)
        self._entries[form.key] = _Entry(canon, float(cut), float(quality))
        self._entries.move_to_end(form.key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def keys(self):
        return list(self._entries.keys())
