"""The port's beyond-paper suites (service, obs, schedules, the sharded
engine, the distributed stage split), its dry-run report and its record
directory, on the CPU.

- each suite's rows carry the row schema of the JAX package's committed
  record (``results/BENCH_<suite>.json``, read as JSON: no JAX run): every
  port row's name, its numbers masked, is a committed row's name masked
  alike, with that row's keys in order, and every committed kind of row
  appears. The numbers in a name are the run's loads and sizes: the port
  runs the reference's ``--smoke`` arguments (the SLA soak with 8
  arrivals, not 24: it replays them in wall-clock time, and the schema
  does not depend on the count; the obs soak with 40 requests, once) or
  small sizes, and a name whose numbers the committed run also used must
  be that name exactly;
- every parity claim holds: ``cut_equal`` on every service row and on the
  distributed stage split, ⟨cut⟩_opt ≥ ⟨cut⟩_ramp;
- ``report.py``'s tables from records written to ``tmp_path`` equal the
  reference's ``dryrun_table`` / ``roofline_table`` at the reference's
  peak (the reference module imports no JAX), and the port prices the
  roofline fraction at the H100 data sheet's;
- ``run.py --save`` writes under ``build/bench/`` and refuses ``results/``.
"""

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import (common, kernel_bench, large_scale, obs_bench, report,
                                    service_bench)
from repro_torch.roofline import analysis as RA

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kind(name: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "#", name)


def _committed(suite: str) -> list:
    return json.loads((RESULTS / f"BENCH_{suite}.json").read_text())["rows"]


def _holds_schema(rows, suite):
    want = _committed(suite)
    kinds = {_kind(r["name"]): list(r) for r in want}
    names = {r["name"] for r in want}
    assert {_kind(r["name"]) for r in rows} == set(kinds)
    for r in rows:
        assert list(r) == kinds[_kind(r["name"])], r["name"]
    # a name of the same kind and numbers as a committed one is that name
    for r in rows:
        same = [n for n in names if _kind(n) == _kind(r["name"])
                and re.findall(r"\d+", n) == re.findall(r"\d+", r["name"])]
        assert same in ([], [r["name"]]), r["name"]


SERVICE = {
    "service": lambda: service_bench.run(**service_bench.SMOKE["run"], device="cpu"),
    "service_mesh": lambda: service_bench.run_distributed(
        **service_bench.SMOKE["distributed"], device="cpu"),
    "service_sla": lambda: service_bench.run_sla_soak(
        **{**service_bench.SMOKE["sla_soak"], "requests": 8}, device="cpu"),
}


@pytest.mark.parametrize("suite", list(SERVICE))
def test_service_smoke_rows_carry_the_schema_and_parity(suite):
    rows = SERVICE[suite]()
    _holds_schema(rows, suite)
    parity = [r for r in rows if "cut_equal" in r]
    assert all(r["cut_equal"] is True for r in parity)
    if suite != "service_sla":
        assert parity
    else:
        assert all(r["attainment_ge_threshold"] in (True, False) for r in rows)
        assert [r["calibrated"] for r in rows] == [True] + [False] * (len(rows) - 1)


def test_obs_rows_carry_the_schema_and_the_ledger_contract():
    rows = obs_bench.run(requests=40, repeats=1, save=False, device="cpu")
    _holds_schema(rows, "obs")
    ledger = rows[-1]
    # nothing builds on the CPU; a warm re-run records nothing either way
    assert ledger["warm_zero"] is True and ledger["cold_compiles"] == 0
    assert rows[2]["overhead_bound"] == obs_bench.OVERHEAD_BOUND == 1.05


def test_schedules_rows_run_both_axis_sizes_on_one_device():
    rows = kernel_bench.run_schedules(n_qubits=8, repeats=1, save=False, device="cpu")
    _holds_schema(rows, "schedules")
    assert [r["name"] for r in rows] == [r["name"] for r in _committed("schedules")]


def test_sharded_engine_rows_and_opt_ge_ramp():
    rows = kernel_bench.run_sharded_engine(n_qubits=8, opt_steps=3, repeats=1,
                                           save=False, device="cpu")
    _holds_schema(rows, "sharded_engine")
    d = dict(kv.split("=") for kv in rows[-1]["derived"].split(";"))
    assert rows[-1]["opt_ge_ramp"] is True and float(d["exp_opt"]) >= float(d["exp_ramp"])


def test_distributed_rows_cut_equal_on_the_data_mesh():
    rows = large_scale.run_distributed(sizes=(120,), save=False, device="cpu")
    _holds_schema(rows, "distributed")
    assert rows[1]["mesh"] == {"data": 2}
    assert rows[-1]["derived"].endswith("cut_equal=True")


def _records(tmp_path):
    """A few dry-run records in the port's format: two meshes, an error, a
    skip, the keys `report.py` reads."""
    base = dict(status="ok", mesh="data=16xmodel=16", chips=256, compile_s=12.5,
                param_bytes=1.5e9, flops_per_device=1.8e13, bytes_per_device=2.6e12,
                collective_wire_bytes=3.1e10, compute_s=0.0182, memory_s=0.7829,
                collective_s=0.6164, bottleneck="memory", model_flops=1.97e16,
                useful_ratio=0.63, route="eager", cuda_initialized=False, tag="")
    recs = {
        "qwen1_5_0_5b__train_4k__singlepod.json": dict(base, arch="qwen1_5_0_5b",
                                                       shape="train_4k"),
        "qwen1_5_0_5b__decode_32k__singlepod.json": dict(
            base, arch="qwen1_5_0_5b", shape="decode_32k", collective_wire_bytes=None,
            compute_s=2e-6, memory_s=0.0016, collective_s=3e-5),
        "mamba2_1_3b__long_500k__multipod.json": dict(
            base, arch="mamba2_1_3b", shape="long_500k", chips=512,
            mesh="pod=2xdata=16xmodel=16"),
        "gemma3_4b__prefill_32k__singlepod.json": dict(
            arch="gemma3_4b", shape="prefill_32k", status="error", error="x"),
        "whisper_medium__long_500k__singlepod.json": dict(
            arch="whisper_medium", shape="long_500k", status="skipped"),
    }
    for fn, rec in recs.items():
        (tmp_path / fn).write_text(json.dumps(rec))
    return report.load(str(tmp_path))


def test_report_tables_equal_the_reference(tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        ref = importlib.import_module("benchmarks.report")
    finally:
        sys.path.remove(str(REPO))
    recs = _records(tmp_path)
    assert recs == ref.load(str(tmp_path))
    assert report.dryrun_table(recs) == ref.dryrun_table(recs)
    for pod in ("single", "multi"):
        assert (report.roofline_table(recs, pod=pod, peak_flops=197e12)
                == ref.roofline_table(recs, pod=pod))
    # the port's fraction is priced at the H100's bf16 peak, 5.02x 197e12
    assert RA.PEAK_FLOPS == 989e12
    ours = report.roofline_table(recs).splitlines()[2]
    theirs = ref.roofline_table(recs).splitlines()[2]
    assert ours.rsplit("|", 2)[0] == theirs.rsplit("|", 2)[0]
    frac = float(ours.rsplit("|", 2)[1].strip().rstrip("%"))
    assert frac == pytest.approx(float(theirs.rsplit("|", 2)[1].strip().rstrip("%"))
                                 * 197 / 989, abs=0.1)


def test_report_write_puts_the_tables_in_a_file(tmp_path, monkeypatch):
    recs = _records(tmp_path)
    monkeypatch.setattr(report, "load", lambda: recs)
    out = tmp_path / "tables.md"
    report.main(["--write", str(out)])
    assert out.read_text() == report.tables(recs) + "\n"
    assert "| qwen1_5_0_5b | train_4k |" in out.read_text()


def test_run_save_writes_under_build_bench_and_never_results(tmp_path):
    before = {p.name: p.stat().st_mtime_ns for p in RESULTS.iterdir()}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    name = f"test_run_save_{os.getpid()}.json"
    target = Path(common.RESULTS_DIR) / name
    try:
        ok = subprocess.run(
            [sys.executable, "-m", "repro_torch.benchmarks.run", "--only", "l_sweep",
             "--device", "cpu", "--save", f"build/bench/{name}"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert ok.returncode == 0, ok.stderr
        assert ok.stdout.splitlines()[0].startswith("# kernels built or loaded in")
        rows = json.loads(target.read_text())
        assert [r["name"] for r in rows] == ["l_sweep/L1", "l_sweep/L2", "l_sweep/L3"]
    finally:
        target.unlink(missing_ok=True)
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only", "l_sweep",
         "--device", "cpu", "--save", "results/BENCH_l_sweep.json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert refused.returncode == 2 and "build/bench" in refused.stderr
    assert {p.name: p.stat().st_mtime_ns for p in RESULTS.iterdir()} == before
    assert common.bench_path("service") == os.path.join(common.RESULTS_DIR,
                                                        "BENCH_service.json")
    assert Path(common.RESULTS_DIR) == REPO / "build" / "bench"
