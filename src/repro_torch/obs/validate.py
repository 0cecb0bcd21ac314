"""Schema and invariant validation of exported traces and metrics
snapshots (a copy of ``repro/obs/validate.py``, which is stdlib-only).

  PYTHONPATH=src python -m repro_torch.obs.validate \\
      --trace trace.jsonl --metrics metrics.json

Trace validation checks the structure and the span-tree invariants: every
record is a complete span with ``t1 >= t0``, every ``parent_id`` resolves
to a span whose interval contains the child's, span ids are unique, and
every ``request`` root carries a terminal ``status`` attribute in
{completed, shed, expired}. Metrics validation checks the
`MetricsRegistry.snapshot()` shape (counters and gauges map names to
numbers; histograms carry count/sum/p50/p99). Both return a list of
violation strings, empty when valid, and the CLI exits nonzero on any.
"""

from __future__ import annotations

import argparse
import json
import sys

TERMINAL_STATUSES = ("completed", "shed", "expired")

_SPAN_KEYS = {"span_id", "parent_id", "name", "t0", "t1", "attrs"}


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_trace_records(records) -> list[str]:
    """Violations in a parsed span list (dicts in `Span.as_dict` shape)."""
    errors: list[str] = []
    by_id: dict = {}
    for i, rec in enumerate(records):
        where = f"span[{i}]"
        if not isinstance(rec, dict):
            errors.append(f"{where}: not an object")
            continue
        missing = _SPAN_KEYS - set(rec)
        if missing:
            errors.append(f"{where}: missing keys {sorted(missing)}")
            continue
        if not isinstance(rec["name"], str) or not rec["name"]:
            errors.append(f"{where}: bad name {rec['name']!r}")
        if not isinstance(rec["span_id"], int):
            errors.append(f"{where}: non-int span_id")
            continue
        if rec["span_id"] in by_id:
            errors.append(f"{where}: duplicate span_id {rec['span_id']}")
        if not (_is_num(rec["t0"]) and _is_num(rec["t1"])):
            errors.append(f"{where}: non-numeric t0/t1")
            continue
        if rec["t1"] < rec["t0"]:
            errors.append(
                f"{where} ({rec['name']}): t1 {rec['t1']} < t0 {rec['t0']}"
            )
        if not isinstance(rec["attrs"], dict):
            errors.append(f"{where}: attrs not an object")
            continue
        by_id[rec["span_id"]] = rec
        if rec["name"] == "request":
            status = rec["attrs"].get("status")
            if status not in TERMINAL_STATUSES:
                errors.append(
                    f"{where}: request span without terminal status "
                    f"(got {status!r})"
                )
    # parent resolution + interval nesting
    for rec in records:
        if not isinstance(rec, dict) or rec.get("parent_id") is None:
            continue
        parent = by_id.get(rec.get("parent_id"))
        name = rec.get("name")
        if parent is None:
            errors.append(
                f"span {rec.get('span_id')} ({name}): dangling parent_id "
                f"{rec.get('parent_id')}"
            )
            continue
        if not (parent["t0"] <= rec["t0"] and rec["t1"] <= parent["t1"]):
            errors.append(
                f"span {rec['span_id']} ({name}) "
                f"[{rec['t0']}, {rec['t1']}] escapes parent "
                f"{parent['span_id']} ({parent['name']}) "
                f"[{parent['t0']}, {parent['t1']}]"
            )
    return errors


def validate_trace_jsonl(text: str) -> list[str]:
    records = []
    errors = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError as e:
            errors.append(f"line {lineno}: not JSON ({e})")
    return errors + validate_trace_records(records)


def validate_metrics(snapshot) -> list[str]:
    errors: list[str] = []
    if not isinstance(snapshot, dict):
        return ["metrics snapshot: not an object"]
    for section in ("counters", "gauges", "histograms"):
        if section not in snapshot:
            errors.append(f"metrics snapshot: missing {section!r}")
            continue
        if not isinstance(snapshot[section], dict):
            errors.append(f"{section}: not an object")
            continue
        for name, val in snapshot[section].items():
            if section == "histograms":
                if not isinstance(val, dict):
                    errors.append(f"histogram {name!r}: not an object")
                    continue
                for k in ("count", "sum", "p50", "p99"):
                    if not _is_num(val.get(k)):
                        errors.append(
                            f"histogram {name!r}: non-numeric {k!r}"
                        )
            elif not _is_num(val):
                errors.append(f"{section[:-1]} {name!r}: non-numeric value")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.validate",
        description="Validate exported JSON-lines traces and metrics "
        "snapshots against the span and metrics schemas.",
    )
    ap.add_argument("--trace", help="JSON-lines trace file to validate")
    ap.add_argument("--metrics", help="metrics snapshot JSON to validate")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("nothing to validate: pass --trace and/or --metrics")

    failures = 0
    if args.trace:
        with open(args.trace) as f:
            errors = validate_trace_jsonl(f.read())
        for e in errors:
            print(f"[obs.validate] trace: {e}", file=sys.stderr)
        print(f"[obs.validate] {args.trace}: "
              f"{'OK' if not errors else f'{len(errors)} violation(s)'}")
        failures += len(errors)
    if args.metrics:
        with open(args.metrics) as f:
            errors = validate_metrics(json.load(f))
        for e in errors:
            print(f"[obs.validate] metrics: {e}", file=sys.stderr)
        print(f"[obs.validate] {args.metrics}: "
              f"{'OK' if not errors else f'{len(errors)} violation(s)'}")
        failures += len(errors)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
