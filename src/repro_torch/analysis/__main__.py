"""Command line: ``python -m repro_torch.analysis [paths] [options]``.

Exit codes: 0 clean (or all findings suppressed/baselined), 1 actionable
findings, 2 usage/crash. Paths default to src/repro_torch;
``chip_smoke.py`` runs it there with --format json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.engine import (
    collect_files,
    load_baseline,
    run_on_sources,
    write_baseline,
)
from repro_torch.analysis.rules import rule_ids

_DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: AST invariant checker for the PyTorch port",
    )
    p.add_argument(
        "paths", nargs="*", default=None,
        help="files or directories to analyze (default: src/repro_torch)",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--baseline", default=_DEFAULT_BASELINE,
        help="baseline file of grandfathered findings "
             "(default: the checked-in one; 'none' disables)",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline to absorb all current findings, "
             "then exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print rule ids and exit",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in rule_ids():
            print(rid)
        return 0

    paths = args.paths or ["src/repro_torch"]
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]

    files = collect_files(paths)
    if not files:
        print(f"reprolint: no .py files under {paths}", file=sys.stderr)
        return 2
    sources = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            sources[path] = f.read()

    baseline_path = None if args.baseline == "none" else args.baseline
    try:
        if args.write_baseline:
            report = run_on_sources(sources, rules=rules, baseline=set())
            write_baseline(baseline_path or _DEFAULT_BASELINE, report.findings)
            print(
                f"reprolint: wrote {len(report.findings)} finding(s) to "
                f"{baseline_path or _DEFAULT_BASELINE}"
            )
            return 0
        report = run_on_sources(
            sources, rules=rules, baseline=load_baseline(baseline_path)
        )
    except KeyError as e:
        print(f"reprolint: {e.args[0]}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(report.as_dict(), indent=2))
    else:
        for f in report.findings:
            print(f.render())
        print(
            f"reprolint: {len(report.findings)} finding(s) in "
            f"{report.files} file(s) "
            f"({report.suppressed} suppressed, {report.baselined} baselined)"
        )
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
