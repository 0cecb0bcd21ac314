"""reprolint for the port (src/repro_torch/analysis): the engine against
the reference's (repro/analysis/engine.py) on shared engine-level
sources, a flagged, a clean and a suppressed fixture for every rule, the
seed's bucket-graph key caught by cache-key, the CLI in a subprocess, and
the Tier-1 gate over src/repro_torch with the empty baseline.

Fixtures are analyzed in memory through `run_on_sources`, the CLI's
entry point without the filesystem walk."""

import ast
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import engine as ref_engine
from repro_torch.analysis import engine, get_rules, rule_ids, run, run_on_sources
from repro_torch.analysis.rules import collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _src(rel):
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        return f.read()


def _rules_of(report):
    return [f.rule for f in report.findings]


# ----------------------------------------------------------------- engine --
_ENGINE_SRC = """
import numpy as np
import torch.distributed as dist
from os import path as osp
from collections import OrderedDict as OD
from . import sibling
from .. import cousin
from .pkg import thing as alias

def f(x):
    return np.linalg.norm(x), dist.all_reduce, osp.join, OD, sibling.g, alias.h, cousin
x = 1  # reprolint: disable=rule-a, rule-b
y = 2  # reprolint: disable=rule-c
# reprolint: disable-file=rule-d
"""


def _chains(tree):
    return [n for n in ast.walk(tree) if isinstance(n, (ast.Name, ast.Attribute))]


@pytest.mark.parametrize("port_path, ref_path", [
    ("src/repro_torch/core/mod.py", "src/repro/core/mod.py"),
    ("/abs/src/repro_torch/core/pkg/__init__.py", "/abs/src/repro/core/pkg/__init__.py"),
    ("snippet/mod.py", "snippet/mod.py"),
])
def test_module_name_qualify_and_suppressions_match_the_reference(port_path, ref_path):
    port = engine.ModuleInfo(port_path, _ENGINE_SRC)
    ref = ref_engine.ModuleInfo(ref_path, _ENGINE_SRC)
    # the module name anchors at the port's package as the reference's
    # anchors at its own; every qualified chain is the same modulo the root
    def swap(name):
        return None if name is None else name.replace("repro_torch", "repro")
    assert swap(port.modname) == ref.modname
    assert {k: swap(v) for k, v in port.bindings.items()} == ref.bindings
    got = [swap(port.qualify(n)) for n in _chains(port.tree)]
    want = [ref.qualify(n) for n in _chains(ref.tree)]
    assert got == want
    assert port.line_suppressions == ref.line_suppressions
    assert port.file_suppressions == ref.file_suppressions == {"rule-d"}
    line_x = _ENGINE_SRC.splitlines().index("x = 1  # reprolint: disable=rule-a, rule-b") + 1
    assert port.suppressed("rule-b", line_x) and not port.suppressed("rule-c", line_x)
    assert port.suppressed("rule-d", 3)


def test_module_name_anchors_at_the_last_port_component():
    assert engine._module_name("x/repro_torch/src/repro_torch/a/b.py") == "repro_torch.a.b"
    assert engine._module_name("src/repro_torch/__init__.py") == "repro_torch"


@pytest.mark.parametrize("path", [
    "src/repro_torch/core/x.py",
    "/home/ci/checkout/src/repro_torch/core/x.py",
    "tests/test_x.py",
    "/elsewhere/tests/test_x.py",
])
def test_fingerprints_match_the_reference_and_ignore_the_root(path):
    args = ("host-read", path, 3, 4, "msg", "fn", "  x  =  t.item()  ")
    port, ref = engine.Finding(*args), ref_engine.Finding(*args)
    assert port.fingerprint == ref.fingerprint
    assert port.as_dict() == ref.as_dict()
    assert port.render() == ref.render()
    rel = engine.Finding("host-read", path.split("/", 1)[1] if path.startswith("/") else path,
                         3, 4, "msg", "fn", "x = t.item()")
    if path.startswith("/"):
        assert rel.fingerprint == port.fingerprint


def test_baseline_round_trip_reads_the_same_in_both_engines(tmp_path):
    findings = [engine.Finding("cache-key", f"src/repro_torch/m{i}.py", i + 1, 0,
                               "m", "s", f"line {i}") for i in range(3)]
    out = tmp_path / "baseline.json"
    engine.write_baseline(str(out), findings)
    want = {f.fingerprint for f in findings}
    assert engine.load_baseline(str(out)) == want
    assert ref_engine.load_baseline(str(out)) == want
    assert engine.load_baseline(str(tmp_path / "missing.json")) == set()
    assert json.loads(out.read_text())["version"] == 1


def test_report_dict_and_exit_codes_match_the_reference():
    f = engine.Finding("cache-key", "src/repro_torch/a.py", 1, 0, "m")
    rf = ref_engine.Finding("cache-key", "src/repro_torch/a.py", 1, 0, "m")
    port = engine.Report([f], 2, 1, 5, {"host-read": 2})
    ref = ref_engine.Report([rf], 2, 1, 5)
    got, want = port.as_dict(), ref.as_dict()
    assert {k: got[k] for k in want} == want
    assert got["suppressed_by_rule"] == {"host-read": 2}
    assert (port.exit_code, ref.exit_code) == (1, 1)
    assert engine.Report([], 0, 0, 1).exit_code == ref_engine.Report([], 0, 0, 1).exit_code == 0


def test_rule_registry_and_unknown_ids():
    assert rule_ids() == ["cache-key", "dispatch-purity", "host-read",
                          "collective-axis", "hot-nondeterminism"]
    with pytest.raises(KeyError):
        get_rules(["cache-key", "tracer-hazard"])


def test_the_linter_imports_neither_torch_nor_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# -------------------------------------------------------------- cache-key --
# lines 40-117 of service/backend.py as they stood before the repair: the bucket
# graphs keyed without the dispatch state
_SEED_BACKEND = '''
import collections
import math
from typing import NamedTuple

import torch

from repro_torch.core import qaoa as qaoa_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.obs.ledger import get_ledger

# eager runs of a bucket on a side stream before its capture, as
# `torch.cuda.graph` asks: they set each kernel's attributes and build the
# autograd engine's state; their launches are real and counted
GRAPH_WARMUP = 2


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # static edges, weights, linear (or None)
    outputs: tuple  # static gammas, betas, re, im, expectation
    launches: collections.Counter  # kernel launches a replay makes
    ops: dict  # (op, impl) → ledger op notes a replay stands for


# process-global, as the kernel libraries are: one graph per bucket key
_GRAPHS: dict = {}


def _graph_key(qcfg: qaoa_mod.QAOAConfig, device, rows: int, e_pad: int,
               linear: bool) -> tuple:
    """What fixes a bucket's graph: the device, rows, padded edges, linear
    terms or none, and every knob of the device part (not ``top_k``)."""
    return (str(device), rows, e_pad, linear, qcfg.n_qubits,
            qcfg.p_layers, qcfg.opt_steps, qcfg.learning_rate, qcfg.ramp_delta,
            qcfg.mixer_group)


def graph_count() -> int:
    """How many buckets have a captured graph."""
    return len(_GRAPHS)


def clear_graphs() -> None:
    """Drop every captured graph and its memory pool."""
    _GRAPHS.clear()


def _capture(qcfg, edges, weights, linears) -> _Graph:
    """Warm up on a side stream, then capture `qaoa.solve_batch_on_device`
    on static copies of the inputs. The launches and ledger notes made
    while capturing ran nothing: they are set aside for each replay to
    add."""
    dev = edges.device
    inputs = tuple(None if t is None else t.clone() for t in (edges, weights, linears))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            qaoa_mod.solve_batch_on_device(*inputs[:2], qcfg, inputs[2])
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.set_aside_launches() as launched, get_ledger().set_aside_ops() as ops:
        with torch.cuda.graph(graph):
            outputs = qaoa_mod.solve_batch_on_device(*inputs[:2], qcfg, inputs[2])
    return _Graph(graph, inputs, outputs, launched, ops)


def solve_graphed(qcfg: qaoa_mod.QAOAConfig, edges, weights, masks,
                  linears=None) -> qaoa_mod.QAOAResult:
    """`qaoa.solve_subgraph_batch` on the card through the bucket's CUDA
    graph (captured first where it is not yet): the same kernels in the
    same order, so the same bits. ``masks`` on the host, as there."""
    key = _graph_key(qcfg, edges.device, *edges.shape[:2], linears is not None)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _capture(qcfg, edges, weights, linears)
'''

_CAPTURED_PROGRAM = {
    "src/repro_torch/core/qaoa.py": _src("core/qaoa.py"),
    "src/repro_torch/core/engine.py": _src("core/engine.py"),
    "src/repro_torch/kernels/ops.py": _src("kernels/ops.py"),
}


def _cache_key(backend_src):
    return run_on_sources(
        {**_CAPTURED_PROGRAM, "src/repro_torch/service/backend.py": backend_src},
        rules=["cache-key"])


def test_cache_key_flags_the_seed_bucket_graph_key():
    rep = _cache_key(_SEED_BACKEND)
    msgs = [(f.symbol, f.message) for f in rep.findings]
    stores = [s for s, m in msgs if "cache '_GRAPHS'" in m]
    assert stores == ["solve_graphed"], msgs
    assert "tuning.state()" in rep.findings[-1].message
    captures = [s for s, m in msgs if m.startswith("capture in '_capture'")]
    assert captures == ["_capture"], msgs


def test_cache_key_passes_the_repaired_backend():
    rep = _cache_key(_src("service/backend.py"))
    assert rep.findings == [], [f.render() for f in rep.findings]


def test_cache_key_suppressed_on_the_seed():
    src = _SEED_BACKEND.replace(
        "        g = _GRAPHS[key] = _capture(qcfg, edges, weights, linears)",
        "        g = _GRAPHS[key] = _capture(qcfg, edges, weights, linears)"
        "  # reprolint: disable=cache-key")
    src = src.replace("        with torch.cuda.graph(graph):",
                      "        with torch.cuda.graph(graph):  # reprolint: disable=cache-key")
    rep = _cache_key(src)
    assert rep.findings == [] and rep.suppressed == 2


def test_cache_key_flags_a_constant_state_in_the_key():
    # a state the key names but the call never read: the capture re-asserts
    # it, yet a graph made with tuning off would replay with tuning on
    src = _src("service/backend.py").replace(
        "tune = tuning.state()", "tune = (\"off\",)")
    rep = _cache_key(src)
    assert {f.symbol for f in rep.findings} == {"solve_graphed", "LocalBackend.prepare"}
    assert all("tuning.state()" in f.message for f in rep.findings)


_FACTORY = """
import functools
from repro_torch.kernels import ops, tuning

@functools.lru_cache(maxsize=8)
def build(n: int{params}):
    def run(x):
{body}
    return run
"""


@pytest.mark.parametrize("params, body, flagged", [
    ("", "        return ops.apply_phase(x, x, x, x)", True),
    (", tune: tuple",
     "        with tuning.using_state(tune):\n"
     "            return ops.apply_phase(x, x, x, x)", False),
    ("",
     "        with tuning.using_state(tuning.state()):\n"
     "            return ops.apply_phase(x, x, x, x)", True),
    ("", "        return x + 1", False),
])
def test_cache_key_lru_factories(params, body, flagged):
    rep = run_on_sources({"src/repro_torch/core/snippet.py":
                          _FACTORY.format(params=params, body=body)},
                         rules=["cache-key"])
    assert bool(rep.findings) == flagged, [f.render() for f in rep.findings]


_LIB_CACHE = """
from repro_torch.kernels import _build, tuning
_VARIANTS = {{}}

def variant(op, dim):
    key = {key}
    if key not in _VARIANTS:
        _VARIANTS[key] = _build.entry(f"{{op}}_{{tuning.param(op, dim, 'tile', 4)}}")
    return _VARIANTS[key]
"""


@pytest.mark.parametrize("key, flagged", [
    ("(op, dim)", True),
    ("(op, dim, tuning.state())", False),
])
def test_cache_key_library_cache_picked_by_a_knob(key, flagged):
    src = _LIB_CACHE.format(key=key)
    rep = run_on_sources({"src/repro_torch/kernels/snippet.py": src},
                         rules=["cache-key"])
    assert bool(rep.findings) == flagged


# -------------------------------------------------------- dispatch-purity --
_DIRECT_BUILD = "from repro_torch.kernels import _build\n\n_build.add_launches({})\n"


@pytest.mark.parametrize("path, src, n", [
    ("src/repro_torch/service/backend.py", _DIRECT_BUILD, 1),
    ("src/repro_torch/core/snippet.py", "import repro_torch.kernels.ref as r\n", 1),
    ("src/repro_torch/core/snippet.py",
     "from repro_torch.kernels.mixer import apply_mixer_bits\n", 1),
    ("src/repro_torch/service/backend.py",
     "from repro_torch.kernels import ops, tuning\n", 0),
    ("src/repro_torch/kernels/ops.py", _DIRECT_BUILD, 0),
    ("tests/test_snippet.py", _DIRECT_BUILD, 0),
    ("src/repro_torch/benchmarks/snippet.py", _DIRECT_BUILD, 0),
])
def test_dispatch_purity(path, src, n):
    rep = run_on_sources({path: src}, rules=["dispatch-purity"])
    assert _rules_of(rep) == ["dispatch-purity"] * n


def test_dispatch_purity_suppressed_like_the_dist_checks():
    src = _DIRECT_BUILD.replace(
        "import _build", "import _build  # reprolint: disable=dispatch-purity (why)")
    rep = run_on_sources({"src/repro_torch/service/x.py": src},
                         rules=["dispatch-purity"])
    assert rep.findings == [] and rep.suppressed == 1
    rep = run_on_sources({"src/repro_torch/core/_dist_checks.py":
                          _src("core/_dist_checks.py")}, rules=["dispatch-purity"])
    assert rep.findings == [] and rep.suppressed == 1


# -------------------------------------------------------------- host-read --
def _qaoa_with(old, new):
    src = _src("core/qaoa.py")
    assert old in src
    return {"src/repro_torch/core/qaoa.py": src.replace(old, new)}


_EXP_LINE = "        exp = ops.expectation(re, im, cutv)\n"


@pytest.mark.parametrize("extra, n", [
    ("        assert exp.sum().item() > 0\n", 1),
    ("        if exp.max() > 0:\n            exp = exp * 1\n", 1),
    ("        torch.cuda.synchronize()\n", 1),
    ("        top = float(exp[0])\n", 1),
    ("        host = exp.cpu()\n", 1),
    ("        shape = int(exp.shape[0])\n", 0),  # metadata, not data
    ("        if n > 3:\n            exp = exp * 1\n", 0),  # a host int
])
def test_host_read_in_solve_batch_on_device(extra, n):
    rep = run_on_sources(_qaoa_with(_EXP_LINE, _EXP_LINE + extra),
                         rules=["host-read"])
    assert _rules_of(rep) == ["host-read"] * n, [f.render() for f in rep.findings]
    if n:
        assert rep.findings[0].symbol == "solve_batch_on_device"


def test_host_read_clean_and_suppressed_on_the_solve():
    rep = run_on_sources({"src/repro_torch/core/qaoa.py": _src("core/qaoa.py")},
                         rules=["host-read"])
    assert rep.findings == []
    srcs = _qaoa_with(_EXP_LINE, _EXP_LINE + "        assert exp.sum().item() > 0"
                      "  # reprolint: disable=host-read (a debug check)\n")
    rep = run_on_sources(srcs, rules=["host-read"])
    assert rep.findings == [] and rep.suppressed == 1


def test_host_read_declared_host_params_and_unrelated_functions():
    # real_mask is the packer's host copy: reading it is host work
    srcs = _qaoa_with("    n_real = np.array(",
                      "    first = int(real_mask[0])\n    n_real = np.array(")
    assert run_on_sources(srcs, rules=["host-read"]).findings == []
    # the same read of a tensor argument is flagged
    srcs = _qaoa_with("    n_real = np.array(",
                      "    first = int(re[0, 0])\n    n_real = np.array(")
    rep = run_on_sources(srcs, rules=["host-read"])
    assert [f.symbol for f in rep.findings] == ["topk_marginal"]
    # outside every dispatch root a host read is fine
    srcs = _qaoa_with("def to_device(", "def report(x):\n    return x.item()\n\n\ndef to_device(")
    assert run_on_sources(srcs, rules=["host-read"]).findings == []


_CAPTURE = """
import torch
from repro_torch.core import helper

def capture(x, n: int):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = helper.step(x)
        {direct}
    return g, y
"""

_HELPER = """
def step(x):
    y = x * 2
    {inner}
    return y
"""


@pytest.mark.parametrize("direct, inner, n", [
    ("pass", "if y.any():\n        y = y + 1", 1),
    ("z = y.tolist()", "pass", 1),
    ("pass", "pass", 0),
])
def test_host_read_in_a_capture_and_its_callees(direct, inner, n):
    rep = run_on_sources({
        "src/repro_torch/core/snippet.py": _CAPTURE.format(direct=direct),
        "src/repro_torch/core/helper.py": _HELPER.format(inner=inner),
    }, rules=["host-read"])
    assert _rules_of(rep) == ["host-read"] * n, [f.render() for f in rep.findings]


def test_host_read_decode_loop_is_checked_and_its_harvest_is_not():
    src = _src("serving/engine.py")
    rep = run_on_sources({"src/repro_torch/serving/engine.py": src}, rules=["host-read"])
    assert rep.findings == [] and rep.suppressed == 2  # the documented all(done)
    unsuppressed = src.replace("  # reprolint: disable=host-read", "")
    rep = run_on_sources({"src/repro_torch/serving/engine.py": unsuppressed},
                         rules=["host-read"])
    assert {f.symbol for f in rep.findings} == {"Engine.generate"}
    assert {f.line for f in rep.findings} == {
        i + 1 for i, line in enumerate(unsuppressed.splitlines())
        if "if bool(torch.all(done))" in line}


# -------------------------------------------------------- collective-axis --
_COLLECTIVE = """
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

def f(t, group, mesh, layout):
    {body}
"""


@pytest.mark.parametrize("body, n", [
    ("dist.all_reduce(t)", 1),
    ("dist.all_reduce(t, group=None)", 1),
    ("funcol.all_reduce(t, 'sum', mesh.get_group('dat'))", 1),
    ("dist.all_gather_into_tensor(t, t, group=make())", 1),
    ("dist.all_reduce(t, group=group)", 0),
    ("dist.all_to_all_single(t, t, group=layout.axis.group)", 0),
    ("funcol.all_reduce(t, 'max', mesh.get_group('data'))", 0),
    ("g = mesh.get_group('model')\n    dist.broadcast(t, 0, group=g)", 0),
    ("g = make()\n    dist.broadcast(t, 0, group=g)", 1),
    ("dist.all_reduce(t)  # reprolint: disable=collective-axis (world on purpose)", 0),
])
def test_collective_axis(body, n):
    rep = run_on_sources({"src/repro_torch/core/snippet.py": _COLLECTIVE.format(body=body)},
                         rules=["collective-axis"])
    assert _rules_of(rep) == ["collective-axis"] * n, [f.render() for f in rep.findings]


def test_collective_axis_passes_the_port_collectives_and_knows_its_axes():
    rep = run_on_sources({"src/repro_torch/core/axis.py": _src("core/axis.py"),
                          "src/repro_torch/models/attention.py": _src("models/attention.py")},
                         rules=["collective-axis"])
    assert rep.findings == []
    from repro_torch.launch.mesh import AXIS_ORDER

    assert collectives.KNOWN_AXES == frozenset(AXIS_ORDER)


# ----------------------------------------------------- hot-nondeterminism --
_CAPTURED_CALLEE = """
import time
import torch

def step(x, gen):
    {body}
    return x

def capture(x, gen):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x, gen)
    return g, y
"""


@pytest.mark.parametrize("body, n", [
    ("x = x * time.time()", 1),
    ("x = x + torch.randn(x.shape)", 1),
    ("x = x + torch.randn(x.shape, generator=gen)", 0),
    ("x = x * time.perf_counter()  # reprolint: disable=hot-nondeterminism (why)", 0),
    ("x = x * 2", 0),
])
def test_nondeterminism_in_a_graph_captured_callee(body, n):
    rep = run_on_sources({"src/repro_torch/core/snippet.py": _CAPTURED_CALLEE.format(body=body)},
                         rules=["hot-nondeterminism"])
    assert _rules_of(rep) == ["hot-nondeterminism"] * n, [f.render() for f in rep.findings]
    if n:
        assert rep.findings[0].symbol == "step"


_CHECKPOINTED = """
import random
from torch.utils.checkpoint import checkpoint

def body(x):
    return x * random.random()

def layer(x):
    return checkpoint(body, x, use_reentrant=False)
"""


_FORWARDED = """
import functools
import random
from torch.utils.checkpoint import checkpoint

def layer(p, x, *, scale):
    return x * scale * {read}

def _maybe_remat(body, remat: bool):
    if not remat:
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)

def stack(p, x):
    body = functools.partial(layer, p, scale=2.0)
    return _maybe_remat(body, True)(x)
"""


def test_nondeterminism_in_a_checkpointed_body():
    rep = run_on_sources({"src/repro_torch/models/snippet.py": _CHECKPOINTED},
                         rules=["hot-nondeterminism"])
    assert [f.symbol for f in rep.findings] == ["body"]


@pytest.mark.parametrize("read, n", [("random.random()", 1), ("1.0", 0)])
def test_nondeterminism_in_a_body_forwarded_to_checkpoint(read, n):
    """A callable parameter handed to `checkpoint` (the remat policy's
    `_maybe_remat`) is the callables its callers pass, through a local
    `functools.partial`."""
    rep = run_on_sources({"src/repro_torch/models/snippet.py": _FORWARDED.format(read=read)},
                         rules=["hot-nondeterminism"])
    assert [f.symbol for f in rep.findings] == ["layer"] * n


@pytest.mark.parametrize("modname, body, n", [
    ("service/scheduler.py", "t = time.perf_counter()", 0),
    ("service/scheduler.py", "t = time.time()", 1),
    ("service/scheduler.py", "r = torch.randint(0, 4, (1,))", 1),
    ("service/scheduler.py", "r = random.random()", 1),
    ("obs/snippet.py", "t = time.perf_counter()", 1),
    ("obs/clock.py", "t = time.perf_counter()", 0),
    ("kernels/tuning.py", "t = time.monotonic()", 1),
    ("kernels/other.py", "t = time.monotonic()", 0),
])
def test_nondeterminism_regions(modname, body, n):
    src = f"import random\nimport time\nimport torch\n\ndef f():\n    {body}\n"
    rep = run_on_sources({f"src/repro_torch/{modname}": src},
                         rules=["hot-nondeterminism"])
    assert _rules_of(rep) == ["hot-nondeterminism"] * n


# ------------------------------------------------------------ replayed set --
def test_the_replayed_regions_of_the_port():
    files = engine.collect_files([PORT])
    project = engine.Project([engine.ModuleInfo(f, open(f, encoding="utf-8").read())
                              for f in files])
    names = {project.info_of(n).qualname for n in project.replayed
             if project.info_of(n) is not None}
    assert [fn.qualname for _, _, fn in project.capture_blocks] == [
        "repro_torch.service.backend._capture"]
    for q in ("repro_torch.core.qaoa.solve_batch_on_device",
              "repro_torch.models.transformer.attn_block",  # checkpointed
              "repro_torch.models.transformer._ssm_layer",
              "repro_torch.kernels.ops._Layer.backward",
              "repro_torch.kernels.phase.expectation",
              "repro_torch.kernels.tuning.param"):
        assert q in names, q
    assert "repro_torch.core.qaoa.topk_marginal" not in names


# ------------------------------------------------------- tier-1 port gate --
def test_port_tree_is_reprolint_clean():
    """The whole src/repro_torch tree passes every rule, with only
    justified inline suppressions and the empty checked-in baseline."""
    baseline = os.path.join(PORT, "analysis", "baseline.json")
    with open(baseline, encoding="utf-8") as f:
        assert json.load(f)["findings"] == []
    report = run([PORT], baseline_path=baseline)
    assert report.findings == [], "\n".join(f.render() for f in report.findings)
    assert report.files > 90


# ------------------------------------------------------------------- CLI --
def _run_cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=120)


def test_cli_json_clean_on_the_port_by_default():
    proc = _run_cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["files"] > 90
    assert payload["suppressed"] == sum(payload["suppressed_by_rule"].values())


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "service" / "snippet.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(_DIRECT_BUILD)
    proc = _run_cli(str(bad), "--format", "json", "--baseline", "none")
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout)["findings"][0]["rule"] == "dispatch-purity"
    assert _run_cli(str(bad), "--rules", "no-such-rule").returncode == 2
    assert _run_cli(str(tmp_path / "empty")).returncode == 2
    out = tmp_path / "baseline.json"
    proc = _run_cli(str(bad), "--write-baseline", "--baseline", str(out))
    assert proc.returncode == 0
    assert _run_cli(str(bad), "--baseline", str(out)).returncode == 0
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0 and proc.stdout.split() == rule_ids()
