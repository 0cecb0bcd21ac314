"""reprolint rule registry for the port.

Each rule module exports a single Rule instance named ``RULE``; ids are
short kebab-case slugs used in suppression comments
(``# reprolint: disable=<id>``), ``--rules`` selection, and baseline
fingerprints. The catalog, with each rule's torch hazard and the bug it
descends from, is the docstring of `repro_torch.analysis`.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.analysis.rules import (
    cache_key,
    collectives,
    determinism,
    dispatch_purity,
    host_read,
)

ALL_RULES = (
    cache_key.RULE,
    dispatch_purity.RULE,
    host_read.RULE,
    collectives.RULE,
    determinism.RULE,
)

_BY_ID = {r.id: r for r in ALL_RULES}


def rule_ids() -> list[str]:
    return [r.id for r in ALL_RULES]


def get_rules(ids: Sequence[str] | None = None):
    if ids is None:
        return ALL_RULES
    unknown = [i for i in ids if i not in _BY_ID]
    if unknown:
        raise KeyError(
            f"unknown rule(s) {unknown}; available: {sorted(_BY_ID)}"
        )
    return tuple(_BY_ID[i] for i in ids)
