"""The port's serve CLI (``python -m repro_torch.launch.serve_maxcut``)
against the JAX one, on the CPU: the same flags and defaults plus
``--device``; on the same seeded mix the same request lines (sizes,
cache hits, planned knobs), batching and cache stats; exports that both
validators accept; the stream, mesh and SLA lines."""

import json
import re

import pytest
import torch

from repro.launch import serve_maxcut as jcli
from repro.obs import validate as jvalidate
from repro_torch.launch import serve_maxcut as tcli
from repro_torch.obs import validate as tvalidate

BASE = ["--requests", "4", "--n-min", "20", "--n-max", "40", "--qubits", "6"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flags(parser):
    return {a.dest: (a.option_strings, a.default) for a in parser._actions
            if a.dest != "help"}


def test_flags_and_defaults_are_the_reference_ones_plus_device():
    j, t = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert t.pop("device") == (["--device"], "cuda")
    assert t == j


def _run(cli, argv, capsys):
    svc = cli.run(argv)
    return svc, capsys.readouterr().out.splitlines()


def _request_shape(lines):
    """Each request line without its value and latency."""
    return [re.sub(r" value=\S+ latency=\S+", "", ln) for ln in lines
            if re.match(r"\[serve_maxcut\] req \d+ ", ln)]


@pytest.mark.parametrize("extra", [[], ["--tenants", "2", "--problem", "mis"]])
def test_same_requests_plans_and_stats_as_reference(extra, capsys):
    argv = BASE + ["--seed", "3", "--repeat-frac", "0.5", *extra]
    jsvc, jout = _run(jcli, argv, capsys)
    tsvc, tout = _run(tcli, argv + ["--device", "cpu"], capsys)
    assert _request_shape(tout) == _request_shape(jout)
    assert len(_request_shape(tout)) == 4
    drop = ("latency", "tenants", "max_inflight_seen")
    jst = {k: v for k, v in jsvc.stats.as_dict().items() if k not in drop}
    tst = {k: v for k, v in tsvc.stats.as_dict().items() if k not in drop}
    assert tst == jst
    assert tsvc.cache.stats.as_dict() == jsvc.cache.stats.as_dict()

    def kind(ln):
        return re.sub(r"\d[\d.]*", "#", ln).split(":")[0]

    assert [kind(ln) for ln in tout] == [kind(ln) for ln in jout]


def test_trace_and_metrics_pass_both_validators(tmp_path, capsys):
    trace, metrics = tmp_path / "t.jsonl", tmp_path / "m.json"
    _, out = _run(tcli, BASE + ["--device", "cpu", "--trace-out", str(trace),
                                "--metrics-out", str(metrics)], capsys)
    assert any(ln.startswith("[serve_maxcut] trace (jsonl,") for ln in out)
    text = trace.read_text()
    names = {json.loads(ln)["name"] for ln in text.splitlines()}
    assert {"request", "admission", "partition", "dispatch", "solve",
            "merge"} <= names
    for v in (tvalidate, jvalidate):
        assert v.validate_trace_jsonl(text) == []
        assert v.validate_metrics(json.loads(metrics.read_text())) == []
    chrome, prom = tmp_path / "t.json", tmp_path / "m.prom"
    _run(tcli, BASE + ["--device", "cpu", "--trace-out", str(chrome),
                       "--trace-format", "chrome", "--metrics-out", str(prom),
                       "--metrics-format", "prom"], capsys)
    events = json.loads(chrome.read_text())["traceEvents"]
    assert {e["name"] for e in events} == names
    assert "service_completed" in prom.read_text()


def test_stream_mesh_and_sla_lines(capsys):
    svc, out = _run(tcli, BASE + ["--device", "cpu", "--stream", "--no-cache",
                                  "--mesh", "data=4", "--deadline", "60"], capsys)
    levels = [ln for ln in out if "best-known cut" in ln]
    m = sum(len(svc.results[r].anytime) for r in svc.results)
    assert len(levels) == m >= 4
    assert "[serve_maxcut] backend: {'backend': 'mesh', 'mesh': {'data': 4}, " \
           "'axes': ['data'], 'devices': 4}" in out
    assert any(ln.startswith("[serve_maxcut] sla: attainment=") for ln in out)
