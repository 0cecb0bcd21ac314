"""The port's observability, CLI flags and examples against the JAX
package's, on the CPU.

- the span tree of a solve, under a recording tracer on an injected
  counter clock, holds the JAX solve's: restricted to the JAX span names,
  the same names, parents, attributes and order, `refine` included; the
  port's own tree (the QAOA's rounds and parts, a span an Adam step, the merge's parts)
  is pinned, with the timings a recording tracer adds;
- device spans: intervals from a fake event source resolve onto the
  tracer's clock and export on a track of their own; no CUDA event is
  made unless the tracer records on the default clock outside a capture;
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

def _tree(spans, names=None):
    """(name, parent's name, attrs) of each span named in ``names`` (all
    when None), in end order, and their names in start order."""
    by_id = {s.span_id: s for s in spans}
    kept = [s for s in spans if names is None or s.name in names]
    return ([(s.name, by_id[s.parent_id].name if s.parent_id is not None else None,
              s.attrs) for s in kept],
            [s.name for s in sorted(kept, key=lambda s: (s.t0, s.span_id))])


def test_solve_span_tree_equals_the_jax_solve():
    """The port's spans of the JAX span names form the JAX tree; the port's
    further spans (the stages' parts) shift a counter clock's stamps and
    the span ids, so those are not compared."""
    cfg = dict(n_qubits=8, opt_steps=1, refine_steps=5)
    jt = jtrace.Tracer(clock=_counter(), record=True)
    tt = ttrace.Tracer(clock=_counter(), record=True)
    with jtrace.use_tracer(jt):
        jpara.solve(jgraph.Graph.erdos_renyi(30, 0.3, seed=1), jpara.ParaQAOAConfig(**cfg))
    with ttrace.use_tracer(tt):
        tpara.solve(tgraph.Graph.erdos_renyi(30, 0.3, seed=1), tpara.ParaQAOAConfig(**cfg),
                    device="cpu")
    assert [s.name for s in jt.spans] == ["partition", "solve_pool", "merge", "refine",
                                          "solve"]
    assert _tree(tt.spans, {s.name for s in jt.spans}) == _tree(jt.spans)
    _both_validate(tt.to_jsonl())
    assert ttrace.get_tracer() is not tt and not ttrace.get_tracer().record


SOLVE_TREE = [  # (name, parent, attrs) in start order: 5 subgraphs, 3 steps
    ("solve", None, {"n": 30, "n_edges": 139}),
    ("partition", "solve", {"n_qubits": 8}),
    ("solve_pool", "solve", {"m": 5, "n_qubits": 8}),
    ("qaoa_round", "solve_pool", {"round": 0, "rows": 5}),
    ("cost_table", "qaoa_round", {}),
    ("adam_step", "qaoa_round", {"step": 0}),
    ("adam_step", "qaoa_round", {"step": 1}),
    ("adam_step", "qaoa_round", {"step": 2}),
    ("final_state", "qaoa_round", {}),
    ("top_k", "qaoa_round", {}),
    ("merge", "solve", {"m": 5}),
    ("merge_plan", "merge", {}),
    ("merge_scan", "merge", {}),
    ("refine", "solve", {"steps": 5}),
    ("report", "solve", {}),
]
STAGE_KEYS = ["merge_s", "partition_s", "refine_s", "solve_s", "total_s"]
PART_KEYS = ["adam_step_s", "merge_plan_s", "merge_scan_s", "qaoa_round_s", "qaoa_tail_s",
             "round_gap_s"]


def test_solve_span_tree_of_the_port():
    """A tiny solve's spans: names, nesting and the steps' host-counted
    ``step``; the report inside the root; the part timings a recording
    tracer adds, each the sum or mean of its spans, and none untraced."""
    g = tgraph.Graph.erdos_renyi(30, 0.3, seed=1)
    cfg = tpara.ParaQAOAConfig(n_qubits=8, opt_steps=3, refine_steps=5)
    tr = ttrace.Tracer(clock=_counter(), record=True)
    with ttrace.use_tracer(tr):
        out = tpara.solve(g, cfg, device="cpu")
    by_id = {s.span_id: s for s in tr.spans}
    assert [(s.name, by_id[s.parent_id].name if s.parent_id is not None else None,
             s.attrs) for s in tr._sorted()] == SOLVE_TREE
    dur = {s.name: s.duration_s for s in tr.spans}
    assert out.timings["adam_step_s"] == 1.0  # three steps of one tick each
    assert out.timings["qaoa_tail_s"] == dur["cost_table"] + dur["final_state"] + dur["top_k"]
    assert (out.timings["merge_plan_s"], out.timings["merge_scan_s"]) == (
        dur["merge_plan"], dur["merge_scan"])
    assert (out.timings["qaoa_round_s"], out.timings["round_gap_s"]) == (dur["qaoa_round"], 0)
    assert [s.attrs for s in tr.spans if s.name == "qaoa_round"] == [{"round": 0, "rows": 5}]
    assert out.timings["total_s"] == dur["solve"]
    assert sorted(out.timings) == sorted(STAGE_KEYS + PART_KEYS)
    _both_validate(tr.to_jsonl())
    assert out.qaoa.probs.shape == (5, cfg.top_k) and out.qaoa.gammas.shape == (5, 3)
    assert np.array_equal(out.qaoa.bitstrings.numpy(), out.candidates)
    assert sorted(tpara.solve(g, cfg, device="cpu").timings) == STAGE_KEYS


def test_qaoa_round_spans_of_a_solve_in_rounds(monkeypatch):
    """Rounds of 3 rows on 5 subgraphs: two ``qaoa_round`` spans under
    ``solve_pool``, each with its round and rows and the round's cost table,
    steps, final state and top-K under it; the traced round timings from
    the spans (on a counter clock, a tick between one round's end and the
    next one's start)."""
    from repro_torch.core import qaoa as tqaoa

    monkeypatch.setattr(tqaoa, "max_rows_per_round", lambda n, p, device: 3)
    g = tgraph.Graph.erdos_renyi(30, 0.3, seed=1)
    cfg = tpara.ParaQAOAConfig(n_qubits=8, opt_steps=2)
    tr = ttrace.Tracer(clock=_counter(), record=True)
    with ttrace.use_tracer(tr):
        out = tpara.solve(g, cfg, device="cpu")
    by_id = {s.span_id: s for s in tr.spans}
    rounds = [s for s in tr._sorted() if s.name == "qaoa_round"]
    assert [(by_id[s.parent_id].name, s.attrs) for s in rounds] == [
        ("solve_pool", {"round": 0, "rows": 3}), ("solve_pool", {"round": 1, "rows": 2})]
    for r in rounds:
        assert [s.name for s in tr._sorted() if s.parent_id == r.span_id] == [
            "cost_table", "adam_step", "adam_step", "final_state", "top_k"]
    assert not any(by_id[s.parent_id].name == "solve_pool" for s in tr.spans
                   if s.name in ("cost_table", "adam_step", "final_state", "top_k"))
    t = out.timings
    assert t["qaoa_round_s"] == sum(s.duration_s for s in rounds) / 2
    assert t["round_gap_s"] == rounds[1].t0 - rounds[0].t1 == 1
    assert t["qaoa_tail_s"] == sum(s.duration_s for s in tr.spans
                                   if s.name in ("cost_table", "final_state", "top_k"))
    _both_validate(tr.to_jsonl())


def test_traced_round_timings_read_the_device_intervals():
    """Where the rounds have device intervals, the round time and the gaps
    between rounds are the card's, not the host's."""
    spans = []
    for i, (h0, h1, d0, d1) in enumerate([(0.0, 1.0, 5.0, 7.0), (1.5, 2.0, 7.25, 9.25),
                                          (2.5, 3.0, 9.75, 11.75)]):
        s = ttrace.Span(i + 1, None, "qaoa_round", h0, {"round": i, "rows": 16,
                                                         "device_t0": d0, "device_t1": d1})
        s.t1 = h1
        spans.append(s)
    t = tpara.traced_timings(spans)
    assert (t["qaoa_round_s"], t["round_gap_s"]) == (2.0, 0.75)
    assert tpara.traced_timings(spans[:1])["round_gap_s"] == 0
    assert tpara.traced_timings([])["qaoa_round_s"] == 0.0


class _FakeEvent:
    """A CUDA event's part the tracer uses, at a device time in seconds."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_intervals_resolve_onto_the_tracer_clock(monkeypatch):
    """Each device span's pair of events lands at the anchor's host time
    less its distance from the anchor; one anchor a device, taken at the
    resolution; host spans keep host time; the Chrome export puts the
    device intervals on track 2 after the host events. With an anchor
    taken before the work (`mark_device`, on "cuda" as on "cuda:0"), the
    distances are scaled by the host's seconds a device second between the
    two anchors."""
    device_times = iter([10.0, 10.25, 10.25, 11.75, 10.0, 12.0])
    anchors = iter([(_FakeEvent(20.0), 1000.0), (_FakeEvent(0.0), 979.0),
                    (_FakeEvent(20.0), 1000.0)])
    taken = []

    def anchor(device, clock):
        taken.append(device)
        return next(anchors)

    monkeypatch.setattr(ttrace, "_cuda_event", lambda device: _FakeEvent(next(device_times)))
    monkeypatch.setattr(ttrace, "_anchor", anchor)
    tr = ttrace.Tracer(record=True)
    cuda = torch.device("cuda", 0)
    with tr.span("solve_pool"):
        for step in range(2):
            with tr.device_span("adam_step", cuda, step=step):
                pass
    with tr.device_span("merge_plan", torch.device("cpu")):
        pass
    steps = [s for s in tr.spans if s.name == "adam_step"]
    assert taken == [] and all("device_t0" not in s.attrs for s in steps)
    tr.resolve_device()
    assert taken == [0]
    assert [(s.attrs["device_t0"], s.attrs["device_t1"]) for s in steps] == [
        (990.0, 990.25), (990.25, 991.75)]
    assert [s.device_s for s in steps] == [0.25, 1.5]
    plan = next(s for s in tr.spans if s.name == "merge_plan")
    assert "device_t0" not in plan.attrs and plan.device_s == plan.duration_s
    tr.resolve_device()  # nothing left to place: no second anchor
    assert taken == [0]
    events = tr.to_chrome()["traceEvents"]
    assert [e["tid"] for e in events] == [1, 1, 1, 1, 2, 2]
    assert [(e["name"], e["ts"], e["dur"], e["args"]) for e in events[4:]] == [
        ("adam_step", 990.0e6, 0.25e6, {"span_id": steps[0].span_id}),
        ("adam_step", 990.25e6, 1.5e6, {"span_id": steps[1].span_id})]
    # marked at device 0 s ↔ host 979 s, anchored at 20 s ↔ 1000 s: 1.05
    # host seconds a device second
    tr.mark_device(torch.device("cpu"))  # no device interval off the card
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tr.mark_device(torch.device("cuda"))  # the current device: index 0
    with tr.device_span("final_state", cuda):
        pass
    tr.resolve_device()
    final = tr.spans[-1]
    assert taken == [0] * 3
    assert final.attrs["device_t0"] == pytest.approx(1000.0 - 10.0 * 1.05)
    assert final.device_s == pytest.approx(2.0 * 1.05)


class _EventSpy:
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        pass


@pytest.mark.parametrize("case", ["not recording", "injected clock", "captured",
                                  "timed"])
def test_no_cuda_event_unless_the_tracer_times_the_device(monkeypatch, case):
    """A device span makes CUDA events only on a recording tracer, on the
    default clock, outside a graph capture ("timed": two, its start and
    end); in the other cases none, and nothing awaits resolution."""
    monkeypatch.setattr(_EventSpy, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _EventSpy)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "captured")
    kw = {"not recording": {}, "injected clock": {"clock": _counter(), "record": True},
          "captured": {"record": True}, "timed": {"record": True}}[case]
    tr = ttrace.Tracer(**kw)
    cuda = torch.device("cuda", 0)
    if not tr.record or case == "injected clock":  # no anchor either
        tr.mark_device(cuda)
    with tr.device_span("adam_step", cuda, step=0):
        pass
    assert _EventSpy.made == (2 if case == "timed" else 0)
    assert len(tr._pending) == (1 if case == "timed" else 0)


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
    # solve, partition, solve_pool (one QAOA round: cost table, one Adam
    # step, final state, top-K), merge (plan, scan), refine, report
    assert f"[maxcut] trace ({fmt}, 13 spans)" in capsys.readouterr().out
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
