"""The port's block-shape tuning: the table, the wrappers' geometry, and the
sweep's harness, on the CPU.

- the helpers, `param` resolution and the state round-trip mirror
  tests/test_kernel_grads.py (the reference's tuning tests);
- the committed table holds only entries from a sweep on the card;
- every wrapper hands its C entry point the built-in geometry with tuning
  off and an override's value with it on, shown through a recording
  stand-in for `_build.entry` with `_build.on_cuda` patched to True (so no
  card is needed; the tensors stay on the CPU and the backend part of the
  keys is ``cpu``); values outside a kernel's range raise;
- the sweep on ``--device cpu`` under a virtual clock: the default first,
  no duplicate candidates, tuned ≤ default, the rows' keys, and
  `write_cache` refusing a CPU sweep.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import kernel_autotune as ka
from repro_torch.kernels import (_build, betagrad, cutbatch, cutvals, fused_layer,
                                 mixer, ops, phase, ref, tuning)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# helpers, resolution, state
# ---------------------------------------------------------------------------

def test_tuning_helpers():
    assert tuning.round_up(5, 4) == 8
    assert tuning.round_up(8, 4) == 8
    assert tuning.clamp_tile(256, 1024) == 256
    assert tuning.clamp_tile(1024, 256) == 256
    assert tuning.pad_chunks(5, 8) == 8
    assert tuning.pad_chunks(100, 8) == 104
    assert tuning.pad_and_tile(100, 64) == (128, 64)
    assert tuning.shape_bucket(1024) == "2^10"
    assert tuning.shape_bucket(1000) == "2^10"
    assert tuning.shape_bucket(1025) == "2^11"
    assert tuning.cache_key("cutvals", 2**24) == "cutvals|2^24|cuda"
    assert tuning.cache_key("cutvals", 300, tuning.backend_of(CPU)) == "cutvals|2^9|cpu"
    with pytest.raises(ValueError):
        tuning.clamp_tile(96, 64)


def test_tuning_param_resolution_and_state_roundtrip():
    key = tuning.cache_key("apply_phase", 4096)
    assert not tuning.enabled()
    assert tuning.param("apply_phase", 4096, "tile", 512) == 512  # disabled
    with tuning.using_overrides({key: {"tile": 2048}}):
        assert tuning.param("apply_phase", 4096, "tile", 512) == 2048
        # the backend comes from the device: a cpu launch misses a cuda key
        assert tuning.param("apply_phase", 4096, "tile", 512, CPU) == 512
        st_on = tuning.state()
    assert tuning.state() == ("off",)
    assert st_on[0] == "on"
    with tuning.using_state(st_on):
        assert tuning.param("apply_phase", 4096, "tile", 512) == 2048
        assert tuning.state() == st_on
    assert tuning.param("apply_phase", 4096, "tile", 512) == 512
    with tuning.using_state(("off",)):
        assert tuning.state() == ("off",)


def test_set_enabled_reads_the_committed_table(monkeypatch, tmp_path):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"entries": {"expectation|2^12|cuda": {"tile": 1024}}}))
    monkeypatch.setattr(tuning, "CACHE_PATH", str(path))
    tuning.invalidate_committed()
    try:
        tuning.set_enabled(True)
        assert tuning.param("expectation", 4096, "tile", 16384) == 1024
        assert tuning.param("expectation", 8192, "tile", 16384) == 16384
    finally:
        tuning.set_enabled(False)
        tuning.invalidate_committed()
    assert tuning.param("expectation", 4096, "tile", 16384) == 16384


def test_committed_tuning_cache_is_valid():
    path = tuning.CACHE_PATH
    assert os.path.exists(path), "committed tuning cache missing"
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == 1
    for field in ("generated_by", "card", "power_limit", "torch_version",
                  "cuda_version"):
        assert payload.get(field), field
    assert "H100" in payload["card"]
    entries = payload["entries"]
    assert entries, "tuning cache has no entries"
    for key, cfg in entries.items():
        op, bucket, backend = key.split("|")
        assert op in tuning.TUNABLE_OPS, key
        assert bucket.startswith("2^") and bucket[2:].isdigit(), key
        assert backend == "cuda", key
        assert set(cfg) <= set(tuning.TUNABLE_OPS[op]), (key, cfg)
        for name, val in cfg.items():
            assert isinstance(val, int) and val >= 1, (key, name, val)


# ---------------------------------------------------------------------------
# the geometry each wrapper hands its C entry point
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """``calls[name]`` collects the arguments of every launch of entry
    point ``name``; no kernel runs."""
    calls = {}

    def entry(name):
        def launch(*args):
            calls.setdefault(name, []).append(args)
            return 0
        return launch

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    return calls


def _planes(b, *shape):
    return [torch.zeros((b, *shape)) for _ in range(3)]


def _launch_all(n=12, k=7, b=2):
    """One launch of each of the ten wrappers at small shapes; returns
    {op key: per-row dim} as each wrapper keys its lookup."""
    dim, dk = 2**n, 2**k
    re, im, cutv = _planes(b, dim)
    ang = torch.zeros(b)
    phase.apply_phase(re, im, cutv, ang)
    phase.expectation(re, im, cutv)
    phase.phase_grad(re, im, re, im, cutv)
    v3 = (b, dim // dk, dk)
    fused_layer.fused_phase_mixer_group(re.view(v3), im.view(v3), cutv.view(v3),
                                        ang, ang, k)
    mixer.mixer_group_trailing(re.view(v3), im.view(v3), ang, k)
    v4 = (b, 2 ** (n - 3 - 3), 2**3, 2**3)  # lo_bit 3, k 3: Y = 8
    mixer.mixer_group_strided(re.view(v4), im.view(v4), ang, 3)
    edges = torch.zeros((b, 5, 2), dtype=torch.int32)
    weights = torch.zeros((b, 5))
    cutvals.cutvals(n, edges, weights)
    idx = torch.zeros((2, 64), dtype=torch.int32)
    cutvals.cutvals_at(idx, edges, weights)
    cutbatch.cut_batch_dense(torch.ones((3, 50)), torch.zeros((50, 50)), 0.0)
    betagrad.beta_grad(re, im, cutv, re, 0, n)
    return {"apply_phase": dim, "expectation": dim, "fused_layer": dim // dk,
            "mixer_matmul": dim // dk, "mixer_strided": 2 ** (n - 3),
            "cutvals": dim, "cutvals_at": 128, "cut_batch_dense": 50}


def _geometry(calls):
    """The geometry arguments of each entry point's last launch."""
    return {
        "apply_phase": {"tile": calls["apply_phase"][-1][8]},
        "expectation": {"parts": calls["expectation"][-1][7]},
        "fused_layer": {"row_tile": calls["fused_layer"][-1][11]},
        "mixer_matmul": {"row_tile": calls["mixer_trailing"][-1][8]},
        "mixer_strided": {"tile_y": calls["mixer"][-1][9]},
        "cutvals": {"tile_b": calls["cutvals"][-1][5]},
        "cutvals_at": {"tile_b": calls["cutvals_at"][-1][8]},
        "cut_batch_dense": dict(zip(("batch_tile", "k_chunk"),
                                    calls["cut_batch_dense"][-1][11:13])),
    }


def test_wrappers_launch_builtin_geometry_with_tuning_off(recorder):
    """Today's constants: common.cuh kTile = 4096 amplitudes a mixer block
    (4096 >> k rows, 2^(12-k) lanes), 1024 states a cutvals block and a
    cutvals_at block, 16384 amplitudes a pass-1
    expectation block, 128 spin rows and 64 staged K a cut_batch_dense
    block."""
    ops.reset_launch_counts()
    _launch_all(n=12, k=7)
    assert _geometry(recorder) == {
        "apply_phase": {"tile": 4096},
        "expectation": {"parts": 1},  # 2^12 < 16384: one block a row
        "fused_layer": {"row_tile": 32},
        "mixer_matmul": {"row_tile": 32},
        "mixer_strided": {"tile_y": 8},  # 2^(12-3) = 512 clamped to Y = 8
        "cutvals": {"tile_b": 1024},
        "cutvals_at": {"tile_b": 1024},
        "cut_batch_dense": {"batch_tile": 128, "k_chunk": 64},
    }
    assert ops.launch_counts() == {
        "cutvals": 1, "cutvals_at": 1, "fused_phase_mixer_group": 1,
        "mixer_group_strided": 1, "mixer_group_trailing": 1, "expectation": 1,
        "apply_phase": 1, "cut_batch_dense": 1, "beta_grad": 1, "phase_grad": 1}


@pytest.mark.parametrize("n,lo,nbits,want", [
    # a launch: (groups, then (g0, k, lanes, slabs, part0) of each, zeros
    # for a missing second), and the partials a row
    (14, 0, 14, ([(1, 0, 12, 1, 1, 0), (1, 12, 2, 1024, 1, 4)], 8)),
    (13, 2, 7, ([(1, 2, 7, 4, 8, 0)], 2)),
    (16, 13, 3, ([(1, 13, 3, 512, 1, 0)], 16)),
    (16, 5, 11, ([(1, 5, 8, 16, 1, 0), (1, 13, 3, 512, 1, 16)], 32)),
    (18, 6, 12, ([(2, 6, 6, 64, 1, 0, 12, 6, 64, 1, 64)], 128)),
])
def test_beta_grad_launches_one_pass_per_group(recorder, n, lo, nbits, want):
    """The ∂β wrapper hands each launch of `ref.beta_grad_launches` (one
    group, or two fused) to one pass with its groups' (g0, k, lanes,
    slabs, slice of the partials), then one final sum over a row's
    partials; one count a call."""
    launches, parts = want
    re = torch.zeros((2, 2**n))
    ops.reset_launch_counts()
    betagrad.beta_grad(re, re, re, re, lo, nbits)
    got = [c[5:19] for c in recorder["beta_grad_pass"]]
    assert got == [(2, n, parts, *w, *[0] * (11 - len(w))) for w in launches]
    assert recorder["beta_grad_final"][-1][2:4] == (2, parts)
    assert ops.launch_counts()["beta_grad"] == 1
    assert [tuple(p) for launch in ref.beta_grad_launches(lo, nbits) for p in launch] == [
        tuple(w[1 + 5 * i:4 + 5 * i]) for w in launches for i in range(w[0])]


@pytest.mark.parametrize("n", [16, 24, 26])
def test_expectation_parts_with_tuning_off_are_todays(recorder, n):
    """max(1, min(1024, 2^n // 16384)) partials a row, as before the knob."""
    re = torch.zeros((1, 2**n))
    phase.expectation(re, re, re)
    assert recorder["expectation"][-1][7] == max(1, min(1024, 2**n // 16384))


def test_wrappers_launch_the_override_with_tuning_on(recorder):
    n, k = 12, 7
    dims = _launch_all(n=n, k=k)
    want = {
        "apply_phase": {"tile": 1024},
        "expectation": {"tile": 512},
        "fused_layer": {"row_tile": 4},
        "mixer_matmul": {"row_tile": 8},
        "mixer_strided": {"tile_y": 4},
        "cutvals": {"tile_b": 512},
        "cutvals_at": {"tile_b": 64},
        "cut_batch_dense": {"batch_tile": 64, "k_chunk": 32},
    }
    table = {tuning.cache_key(op, dims[op], "cpu"): cfg for op, cfg in want.items()}
    with tuning.using_overrides(table):
        _launch_all(n=n, k=k)
    got = _geometry(recorder)
    assert got.pop("expectation") == {"parts": 2**n // 512}
    want.pop("expectation")
    assert got == want


@pytest.mark.parametrize("op,cfg", [
    ("apply_phase", {"tile": 128}),  # below one amplitude a thread
    ("apply_phase", {"tile": 3000}),  # not a power of two
    ("expectation", {"tile": 64}),
    ("fused_layer", {"row_tile": 64}),  # 64 * 2^7 amplitudes > the shared tile
    ("mixer_matmul", {"row_tile": 3}),
    ("mixer_strided", {"tile_y": 1024}),  # 2^3 * 1024 > the shared tile
    ("cutvals", {"tile_b": 4096}),
    ("cutvals", {"tile_b": 768}),  # not a power of two
    ("cutvals_at", {"tile_b": 16}),
    ("cutvals_at", {"tile_b": 4096}),
    ("cut_batch_dense", {"batch_tile": 256}),
    ("cut_batch_dense", {"batch_tile": 32}),
    ("cut_batch_dense", {"k_chunk": 16}),
])
def test_out_of_range_knobs_raise(recorder, op, cfg):
    dims = {"apply_phase": 4096, "expectation": 4096, "fused_layer": 32,
            "mixer_matmul": 32, "mixer_strided": 512, "cutvals": 4096,
            "cutvals_at": 128, "cut_batch_dense": 50}
    with tuning.using_overrides({tuning.cache_key(op, dims[op], "cpu"): cfg}):
        with pytest.raises(ValueError, match="range|power of two|below|outside|instances"):
            _launch_all(n=12, k=7)


# ---------------------------------------------------------------------------
# the sweep's harness on the CPU
# ---------------------------------------------------------------------------

class _VirtualClock:
    """Advances by a cost computed from the active override table, so
    candidates differ in time deterministically; counts its reads."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self):
        self.reads += 1
        cfg = tuning.active_config() if tuning.enabled() else {}
        vals = [v for entry in cfg.values() for v in entry.values()]
        self.t += 1e-3 * (1 + (sum(vals) * 7919) % 13)
        return self.t


@pytest.fixture(scope="module")
def smoke_sweep():
    clock = _VirtualClock()
    seen = []

    def check(op, cand, out, default_out):
        seen.append((op, cand))
        outs = out if isinstance(out, tuple) else (out,)
        dflt = default_out if isinstance(default_out, tuple) else (default_out,)
        for a, b in zip(outs, dflt):
            assert torch.equal(a, b), (op, cand)

    rows, entries = ka.sweep_all("cpu", ka.SMOKE, repeats=2, clock=clock, check=check)
    return rows, entries, clock, seen


def test_sweep_puts_the_default_first_and_never_loses_to_it(smoke_sweep):
    rows, entries, clock, seen = smoke_sweep
    swept = [r for r in rows if "speedup_vs_default" in r]
    assert {r["op"] for r in swept} == set(tuning.TUNABLE_OPS)
    assert clock.reads > 0
    defaults = {
        "apply_phase": {"tile": 1024},  # 4096 clamped to the 2^10 row
        "expectation": {"tile": 1024},
        "mixer_matmul": {"row_tile": 8},  # 32 clamped to R = 2^3
        "fused_layer": {"row_tile": 8},
        "mixer_strided": {"tile_y": 128},  # 512 clamped to Y = 2^7
        "cutvals": {"tile_b": 1024},
        "cutvals_at": {"tile_b": 1024},
        "cut_batch_dense": {"batch_tile": 128, "k_chunk": 64},
    }
    for r in swept:
        assert r["default_config"] == defaults[r["op"]], r["name"]
        assert r["tuned_s"] <= r["default_s"]
        assert r["speedup_vs_default"] >= 1.0
        assert r["runtime_s"] == r["tuned_s"]
        assert entries[f"{r['op']}|{r['bucket']}|cpu"] == r["config"]
    # every non-default candidate was held against the default's output
    n_checked = sum(r["candidates"] - 1 for r in swept)
    assert len(seen) == n_checked > 0
    summary = rows[-1]
    assert summary["name"] == "kernel_autotune/tuned_vs_default"
    assert summary["tuned_ge_default"] and summary["ops_swept"] == len(swept)


def test_sweep_candidates_are_distinct():
    assert ka._dedup([{"a": 1, "b": 2}, {"b": 2, "a": 1}, {"a": 2, "b": 2}]) == [
        {"a": 1, "b": 2}, {"a": 2, "b": 2}]
    assert ka._pow2_divisors(96, lo=4, hi=64) == [4, 8, 16, 32]


def test_sweep_rows_carry_the_schema(smoke_sweep):
    rows, _, _, _ = smoke_sweep
    keys = {"name", "runtime_s", "op", "bucket", "mode", "card", "power_limit",
            "default_s", "tuned_s", "speedup_vs_default", "config", "candidates",
            "flops", "bytes_accessed", "model_bound_s", "achieved_frac", "derived"}
    swept = [r for r in rows if "speedup_vs_default" in r]
    for r in swept:
        assert keys <= set(r), keys - set(r)
        assert r["mode"] == "cpu" and r["card"] == "cpu"
        assert r["achieved_frac"] is None  # no device metric from a CPU run
        assert r["model_bound_s"] > 0 and r["candidates"] >= 1
        assert r["name"] == f"kernel_autotune/{r['op']}_{r['bucket']}"
    relayout = [r for r in rows if r.get("op") == "mixer_relayout"]
    assert len(relayout) == 1
    assert {"fused_s", "unfused_s", "relayout_speedup", "fused_ge_unfused"} <= set(
        relayout[0])


def test_write_cache_refuses_a_cpu_sweep(smoke_sweep, tmp_path):
    _, entries, _, _ = smoke_sweep
    path = tmp_path / "t.json"
    with pytest.raises(ValueError, match="card only"):
        ka.write_cache(entries, "cpu", path=str(path))
    cuda_keys = {k.replace("|cpu", "|cuda"): v for k, v in entries.items()}
    with pytest.raises(ValueError, match="card only"):
        ka.write_cache(cuda_keys, "cpu", path=str(path))
    assert not path.exists()


def test_bench_json_envelope(smoke_sweep, tmp_path):
    from repro_torch.benchmarks.common import write_bench_json

    rows, _, _, _ = smoke_sweep
    path = write_bench_json(str(tmp_path / "out" / "k.json"), ka.SUITE, rows, "cpu")
    payload = json.loads(Path(path).read_text())
    assert {"suite", "torch_version", "cuda_version", "card", "power_limit",
            "device_count", "rows"} <= set(payload)
    assert payload["card"] == "cpu" and payload["rows"] == json.loads(
        json.dumps(rows, default=str))


def test_autotune_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "rows.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.kernel_autotune", "--smoke",
         "--device", "cpu", "--write", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "kernel_autotune/tuned_vs_default" in proc.stdout
    assert json.loads(out.read_text())["rows"]
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.kernel_autotune", "--smoke",
         "--device", "cpu", "--write-cache"],
        env=env, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "card" in refused.stderr
