"""The port's observability, CLI flags and examples against the JAX
package's, on the CPU.

- the span tree of a solve, under a recording tracer on an injected
  counter clock, is the JAX solve's: its JSON lines are byte-equal (names,
  parent links, attributes and stamps), `refine` included;
- the port's JSON-lines and Chrome exports pass both packages' validators;
- `MetricsRegistry` gives byte-equal JSON and Prometheus text for the same
  operations;
- the build ledger has the reference's snapshot keys, records one build
  event per CUDA source built or loaded, and none once the libraries are
  loaded (a warm process after `reset()`);
- the CLI's refinement, oracle, GW and trace-export flags, and the two
  examples, run on the CPU; the examples' cuts lie within ``BAND`` of Σ|w|
  of the JAX library functions run on the same graph and config (the JAX
  examples parse their flags at import, so the tests call the library).
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import paraqaoa as jpara
from repro.core.baselines import goemans_williamson as jgoemans_williamson
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.obs import validate as jvalidate
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import paraqaoa as tpara
from repro_torch.kernels import _build
from repro_torch.obs import ledger as tledger
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.obs import validate as tvalidate

BAND = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _counter():
    return itertools.count().__next__


def _both_validate(text):
    assert tvalidate.validate_trace_jsonl(text) == []
    assert jvalidate.validate_trace_jsonl(text) == []


def _chrome_records(doc):
    """The span records of a Chrome export, stamps in microseconds."""
    return [{"span_id": e["args"]["span_id"], "parent_id": e["args"].get("parent_id"),
             "name": e["name"], "t0": e["ts"], "t1": e["ts"] + e["dur"],
             "attrs": {k: v for k, v in e["args"].items()
                       if k not in ("span_id", "parent_id")}}
            for e in doc["traceEvents"]]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_solve_span_tree_equals_the_jax_solve():
    cfg = dict(n_qubits=8, opt_steps=1, refine_steps=5)
    jt = jtrace.Tracer(clock=_counter(), record=True)
    tt = ttrace.Tracer(clock=_counter(), record=True)
    with jtrace.use_tracer(jt):
        jpara.solve(jgraph.Graph.erdos_renyi(30, 0.3, seed=1), jpara.ParaQAOAConfig(**cfg))
    with ttrace.use_tracer(tt):
        tpara.solve(tgraph.Graph.erdos_renyi(30, 0.3, seed=1), tpara.ParaQAOAConfig(**cfg),
                    device="cpu")
    assert [s.name for s in tt.spans] == ["partition", "solve_pool", "merge", "refine",
                                          "solve"]
    assert tt.to_jsonl() == jt.to_jsonl()
    _both_validate(tt.to_jsonl())
    assert ttrace.get_tracer() is not tt and not ttrace.get_tracer().record


def test_exports_pass_both_validators(tmp_path):
    tr = ttrace.Tracer(clock=_counter(), record=True)
    with ttrace.use_tracer(tr):
        out = tdist.solve_distributed(
            tgraph.Graph.erdos_renyi(24, 0.3, seed=2),
            tpara.ParaQAOAConfig(n_qubits=6, opt_steps=1, refine_steps=3), "model=2",
            device="cpu")
    names = {s.name for s in tr.spans}
    assert {"solve", "partition", "solve_pool", "sharded_ascent", "merge",
            "refine"} <= names and out.report.extra["sharded_subproblems"] > 0
    path = tr.export(str(tmp_path / "t.jsonl"))
    text = open(path).read()
    assert text.rstrip("\n") == tr.to_jsonl()
    _both_validate(text)
    cpath = tr.export(str(tmp_path / "t.json"), "chrome")
    doc = json.load(open(cpath))
    assert doc == json.loads(json.dumps(tr.to_chrome()))
    assert all(e["ph"] == "X" for e in doc["traceEvents"])
    records = _chrome_records(doc)
    assert len(records) == len(tr.spans)
    assert tvalidate.validate_trace_records(records) == []
    assert jvalidate.validate_trace_records(records) == []
    with pytest.raises(ValueError):
        tr.export(str(tmp_path / "t.x"), "xml")


def test_tracer_api_matches_the_reference():
    """begin/end with explicit parents, ROOT, span_at and attach, on both
    tracers: byte-equal exports."""
    out = []
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(clock=_counter(), record=True)
        root = tr.begin("request", rid=1)
        with tr.attach(root):
            with tr.span("stage", k=2):
                orphan = tr.begin("other", parent=mod.ROOT)
                tr.end(orphan, status="shed")
            tr.span_at("window", 3.0, 4.0, attempt=1)
        tr.end(root, status="completed")
        with pytest.raises(ValueError):
            tr.end(root)
        out.append((tr.to_jsonl(), json.dumps(tr.to_chrome(), sort_keys=True)))
    assert out[0] == out[1]
    _both_validate(out[1][0])


def test_set_tracer_returns_the_previous_one():
    tr = ttrace.Tracer(record=True)
    prev = ttrace.set_tracer(tr)
    try:
        assert ttrace.get_tracer() is tr
    finally:
        assert ttrace.set_tracer(prev) is tr


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_registry_outputs_are_byte_equal():
    rng = np.random.default_rng(3)
    samples = rng.exponential(0.2, 40).tolist()
    outs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("solve.requests").inc(3)
        reg.counter("solve.requests").inc()
        reg.gauge("card.memory-gb").set(19.4)
        h = reg.histogram("solve.latency_s")
        for x in samples:
            h.observe(x)
        reg.attach_histogram("refine.latency_s", mod.Histogram.restore(h.snapshot()))
        outs.append((reg.to_json(), reg.to_prometheus(), h.percentile(0.99),
                     mod.percentile(samples, 0.5)))
    assert outs[0] == outs[1]
    assert tvalidate.validate_metrics(json.loads(outs[1][0])) == []
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# the build ledger
# ---------------------------------------------------------------------------

def test_ledger_snapshot_keys_and_a_warm_solve_records_no_build():
    led = tledger.get_ledger()
    jl = jledger.CompileLedger()
    assert led.snapshot().keys() == jl.snapshot().keys()
    g = tgraph.Graph.erdos_renyi(24, 0.3, seed=4)
    cfg = tpara.ParaQAOAConfig(n_qubits=8, opt_steps=1)
    tpara.solve(g, cfg, device="cpu")
    led.reset()
    tpara.solve(g, cfg, device="cpu")
    snap = led.snapshot()
    assert snap["builds"] == 0 and snap["compiles"] == 0 and snap["events"] == []
    assert snap["op_traces"]["cutvals[plain]"] == 1
    assert snap["op_traces"]["apply_layer[plain]"] > 0
    assert not any(k.endswith("[cuda]") for k in snap["op_traces"])


def test_build_all_records_one_build_event_a_source(tmp_path, monkeypatch):
    """A build directory whose libraries an earlier build left: each is
    loaded once, one build event a source; a second call loads nothing."""
    lib = next(p for p in (os.path.join(os.path.dirname(torch.__file__), "lib", n)
                           for n in ("libc10.so", "libtorch_cpu.so")) if os.path.exists(p))
    out_dir = tmp_path / _build.source_hash()
    out_dir.mkdir()
    for name in _build.SOURCES:
        os.symlink(lib, out_dir / f"lib{name}.so")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "SIGNATURES", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    led = tledger.get_ledger()
    led.reset()
    _build.build_all()
    assert [e.name for e in led.builds] == list(_build.SOURCES)
    assert {e.key for e in led.builds} == {_build.source_hash()}
    assert all(e.duration_s >= 0 for e in led.builds)
    led.reset()
    _build.build_all()
    assert led.count("build") == 0


# ---------------------------------------------------------------------------
# the CLI and the examples
# ---------------------------------------------------------------------------

def test_cli_refine_oracle_and_gw_on_cpu(capsys):
    from repro_torch.launch import solve_maxcut

    out = solve_maxcut.run(["--device", "cpu", "--n", "16", "--qubits", "8",
                            "--opt-steps", "2", "--refine", "20", "--check-oracle",
                            "--compare-gw"])
    text = capsys.readouterr().out
    assert "[maxcut] oracle: brute-force optimum" in text
    assert "[maxcut] GW reference" in text and "refine_s" in text
    assert np.isfinite(out.cut_value)
    with pytest.raises(SystemExit, match="n <= 18"):
        solve_maxcut.run(["--device", "cpu", "--n", "20", "--qubits", "8",
                          "--opt-steps", "0", "--check-oracle"])


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
def test_cli_trace_out(tmp_path, capsys, fmt):
    from repro_torch.launch import solve_maxcut

    path = tmp_path / f"trace.{fmt}"
    solve_maxcut.run(["--device", "cpu", "--n", "24", "--qubits", "8", "--opt-steps", "1",
                      "--refine", "5", "--problem", "mis", "--trace-out", str(path),
                      "--trace-format", fmt])
    assert f"[maxcut] trace ({fmt}, 5 spans)" in capsys.readouterr().out
    if fmt == "jsonl":
        _both_validate(path.read_text())
        assert tvalidate.main(["--trace", str(path)]) == 0
    else:
        records = _chrome_records(json.loads(path.read_text()))
        assert [r["name"] for r in records][0] == "solve"
        assert tvalidate.validate_trace_records(records) == []


def test_solve_16k_example_within_band_of_jax():
    from repro_torch.examples import solve_16k

    out, ls_rep = solve_16k.main(["--n", "200", "--qubits", "8", "--device", "cpu"])
    jg = jgraph.Graph.erdos_renyi(200, 0.01, seed=0)
    jout = jpara.solve(jg, jpara.ParaQAOAConfig(n_qubits=8, top_k=1, p_layers=2,
                                                opt_steps=10, beam_width=64,
                                                refine_steps=200))
    scale = float(np.abs(np.asarray(jg.weights)).sum())
    assert abs(out.cut_value - jout.cut_value) <= BAND * scale, (out.cut_value,
                                                                 jout.cut_value)
    assert out.cut_value <= scale and ls_rep.cut_value <= scale
    assert ls_rep.method == "local_search"


def test_quickstart_example_within_band_of_jax():
    from repro_torch.examples import quickstart

    out, gw_rep = quickstart.main(["--device", "cpu"])
    jg = jgraph.Graph.erdos_renyi(n=120, p=0.3, seed=0)
    jout = jpara.solve(jg, jpara.ParaQAOAConfig(n_qubits=10, top_k=2, p_layers=3,
                                                opt_steps=30))
    _, jgw, _ = jgoemans_williamson(jg, steps=250, rounds=64)
    scale = float(np.abs(np.asarray(jg.weights)).sum())
    assert abs(out.cut_value - jout.cut_value) <= BAND * scale
    assert abs(gw_rep.cut_value - jgw) <= BAND * scale, (gw_rep.cut_value, jgw)


@pytest.mark.parametrize("argv", [["--mesh", "data=2"], ["--mesh", "data=2,model=2"],
                                  ["--merge", "striped"]])
def test_solve_16k_data_axis_raises(argv):
    """The example's data-axis argv run, and give the cut and assignment of
    the same run without the batch axis (the single-device solve, or the
    model-only mesh); the merge stripes over the 2 data shards."""
    from repro_torch.examples import solve_16k

    base = ["--n", "40", "--qubits", "6", "--device", "cpu"]
    out, _ = solve_16k.main([*base, *argv])
    plain = (["--mesh", "model=2"] if "data=2,model=2" in argv else [])
    want, _ = solve_16k.main([*base, *plain])
    assert out.cut_value == want.cut_value
    np.testing.assert_array_equal(out.assignment, want.assignment)
    if "--mesh" in argv:
        assert out.report.extra["merge_shards"] == 2
