"""The §Dry-run and §Roofline tables of the port's dry-run records (port
of ``benchmarks/report.py``).

Reads ``results/dryrun_torch/*.json`` (written by
``python -m repro_torch.launch.dryrun``: the reference's record keys plus
``route``, the counters, ``notes`` and ``cuda_initialized``) and prints
the tables; ``--write PATH`` writes them to PATH. The roofline fraction
prices ``model_flops`` at the H100 data sheet's bf16 peak
(`roofline.analysis.PEAK_FLOPS`), the peak the records' terms use. It
never rewrites ``docs/EXPERIMENTS.md``, which holds the JAX package's
tables.

    python -m repro_torch.benchmarks.report [--write PATH]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR as RESULTS
from repro_torch.roofline.analysis import PEAK_FLOPS

ARCH_ORDER = [
    "qwen1_5_0_5b", "gemma3_4b", "internlm2_20b", "gemma3_27b",
    "internvl2_2b", "moonshot_v1_16b_a3b", "arctic_480b", "whisper_medium",
    "zamba2_2_7b", "mamba2_1_3b", "paraqaoa",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(results_dir=RESULTS):
    recs = []
    for fn in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        r["_pod"] = "multi" if "multipod" in fn else "single"
        recs.append(r)
    return recs


def _key(r):
    a = ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER else 99
    s = SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 99
    return (a, s, r["_pod"])


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | status | compile_s | params/dev | HLO FLOPs/dev | HLO bytes/dev | wire bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | - | SKIP (see §4 DESIGN.md) | - | - | - | - | - |"
            )
            continue
        pb = r.get("param_bytes")
        chips_model = 16
        lines.append(
            "| {arch} | {shape} | {mesh} | {status} | {c:.0f} | {pd} | {fl:.2e} | {by:.2e} | {wb} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r.get("mesh", "-"),
                status=r["status"].upper(), c=r.get("compile_s", 0),
                pd=_fmt_bytes(pb / chips_model if pb else None),
                fl=r.get("flops_per_device", 0) or 0,
                by=r.get("bytes_per_device", 0) or 0,
                wb=_fmt_bytes(r.get("collective_wire_bytes")),
            )
        )
    return "\n".join(lines)


def roofline_table(recs, pod="single", peak_flops=PEAK_FLOPS):
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | bottleneck | MODEL_FLOPS | useful ratio | roofline fraction |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        if r.get("_pod") != pod:
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | SKIP | - | - | - |")
            continue
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | - | - | - | ERROR | - | - | - |"
            )
            continue
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        ideal = r["model_flops"] / (r["chips"] * peak_flops)
        frac = ideal / dom if dom > 0 else 0.0
        lines.append(
            "| {arch} | {shape} | {c:.4f} | {m:.4f} | {x:.4f} | {b} | {mf:.2e} | {u:.2f} | {f:.1%} |".format(
                arch=r["arch"], shape=r["shape"], c=r["compute_s"],
                m=r["memory_s"], x=r["collective_s"], b=r["bottleneck"],
                mf=r["model_flops"], u=r["useful_ratio"], f=frac,
            )
        )
    return "\n".join(lines)


def tables(recs) -> str:
    """Both tables as one markdown text: the dry-run over both meshes, the
    roofline of each."""
    return "\n".join([
        "## §Dry-run (both meshes)\n",
        dryrun_table(recs),
        "\n## §Roofline (single-pod 16×16)\n",
        roofline_table(recs, pod="single"),
        "\n## §Roofline (multi-pod 2×16×16)\n",
        roofline_table(recs, pod="multi"),
    ])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.report")
    ap.add_argument("--write", default=None, metavar="PATH",
                    help="write the tables to PATH instead of printing them")
    args = ap.parse_args(argv)
    text = tables([r for r in load() if not r.get("tag")])
    if args.write:
        with open(args.write, "w") as f:
            f.write(text + "\n")
        print(f"wrote tables into {args.write}")
    else:
        print(text)


if __name__ == "__main__":
    main()
