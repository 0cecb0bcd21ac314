"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``, the
dry-run half of ``roofline/analysis.py``) against the JAX package's, on
the CPU.

What each comparison holds, and why:

- the cell grid, ``input_specs``, ``decode_state_specs_abstract`` and
  ``model_flops_for_cell`` are shape arithmetic: equal to the reference's
  for every cell (``model_flops_for_cell`` exactly, float for float);
- the roofline's bottleneck rule and `parse_collectives`' ring factors:
  the same selection and the same wire bytes on a tally of the reference's
  HLO snippet's collectives (``tests/test_roofline_specs.py``);
- the counter sees each rank's local shards: a ``Shard(1)`` product over
  `model` = 16 counts 1/16 of its dense FLOPs;
- ``run_cell`` at published width on the fake 256-rank world: status ok,
  CUDA untouched, every key of the reference's record; a real forward
  after it in the same process bitwise equal to one before it (the RoPE
  tables are not cached under fake tensors);
- the model knobs, set, leave a one-device forward bitwise unchanged (on
  plain tensors a hint returns its input);
- the ``--qaoa`` CLI in a subprocess, time-limited.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import specs as jspecs
from repro.models import decode as jdecode
from repro.roofline import analysis as janalysis
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import build_model
from repro_torch.roofline import analysis as tanalysis

REPO = Path(__file__).resolve().parents[1]


def _cells():
    return [c for c in tspecs.all_cells() if isinstance(c, tspecs.Cell)]


def _jax_cell(cell):
    return jspecs.get_cell(cell.arch, cell.shape)


def test_all_cells_grid_is_complete():
    cells = tspecs.all_cells()
    assert len(cells) == 40  # 10 archs × 4 shapes
    skips = [c for c in cells if isinstance(c, tspecs.SkipCell)]
    assert len(skips) == 6  # pure full-attention archs skip long_500k
    assert all(s.shape == "long_500k" for s in skips)
    assert {s.arch for s in skips} == {
        "qwen1_5_0_5b", "internlm2_20b", "internvl2_2b",
        "moonshot_v1_16b_a3b", "arctic_480b", "whisper_medium",
    }
    for c in cells:
        if isinstance(c, tspecs.Cell) and c.shape == "long_500k":
            assert c.arch in tspecs.LONG_OK


def test_input_specs_match_reference_for_every_cell():
    for cell in _cells():
        want = jspecs.input_specs(_jax_cell(cell))
        got = tspecs.input_specs(cell)
        assert list(got) == list(want), cell
        for k, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[k].shape), (cell.arch, cell.shape, k)
            assert str(spec.dtype).removeprefix("torch.") == str(want[k].dtype), (cell, k)


def test_decode_state_specs_abstract_match_reference():
    decode = [c for c in _cells() if c.kind == "decode"]
    assert len(decode) == 14
    for cell in decode:
        jc = _jax_cell(cell)
        want = jax.eval_shape(lambda: jdecode.init_decode_state(jc.cfg, jc.batch, jc.seq))
        got = tspecs.decode_state_specs_abstract(cell)
        for field in want._fields:
            w, g = getattr(want, field), getattr(got, field)
            assert (w is None) == (g is None), (cell.arch, field)
            if w is not None:
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape), (cell.arch, cell.shape, field)
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (cell, field)


def test_model_flops_for_cell_equal_reference_for_all_34_cells():
    cells = _cells()
    assert len(cells) == 34
    for cell in cells:
        jc = _jax_cell(cell)
        n = cell.cfg.n_active_params()
        assert n == jc.cfg.n_active_params()
        assert (tanalysis.model_flops_for_cell(cell, n)
                == janalysis.model_flops_for_cell(jc, jc.cfg.n_active_params())), cell


def test_roofline_bottleneck_selection():
    def roof(flops=0.0, byts=0.0, wire=0.0):
        return tanalysis.build_roofline(
            arch="x", shape="y", mesh_desc="m", chips=4,
            cost={"flops": flops, "bytes accessed": byts},
            stats=tanalysis.CollectiveStats({}, {}, wire), model_flops=100.0)

    r = roof(flops=tanalysis.PEAK_FLOPS, byts=1.0)
    assert r.bottleneck == "compute" and r.compute_s == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(100.0 / (tanalysis.PEAK_FLOPS * 4))
    assert roof(byts=tanalysis.HBM_BW, flops=1.0).bottleneck == "memory"
    assert roof(wire=tanalysis.LINK_BW, byts=1.0).bottleneck == "collective"
    assert r.peaks == {"data_sheet": "H100 SXM", "flops_per_s": 989e12,
                       "hbm_bytes_per_s": 3.35e12, "link_bytes_per_s": 50e9}
    jkeys = {f.name for f in dataclasses.fields(janalysis.Roofline)}
    assert jkeys <= set(r.to_dict())


def test_collective_factors_match_parse_collectives():
    hlo = """
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={{0,1,2,3}}
  %ag.1 = bf16[64,128]{1,0} all-gather(bf16[8,128]{1,0} %y), replica_groups=[8,2]<=[16]
  %cp = f32[256]{0} collective-permute(f32[256]{0} %z), source_target_pairs={{0,1}}
  %done = f32[1024]{0} all-reduce-done(f32[1024]{0} %ar)
"""
    want = janalysis.parse_collectives(hlo)
    # the same collectives as a dispatch-mode tally: (op, result bytes, group)
    got = tanalysis.collective_stats([("all-reduce", 4096, 4), ("all-gather", 16384, 2),
                                      ("collective-permute", 1024, 2)])
    assert got.counts == want.counts
    assert got.bytes_by_op == want.bytes_by_op
    assert got.wire_bytes == want.wire_bytes == 4096 * 1.5 + 16384 * 0.5 + 1024
    assert tanalysis.collective_factor("reduce-scatter", 16) == 15 / 16
    assert tanalysis.collective_factor("all-to-all", 16) == 15 / 16


@pytest.fixture(scope="module")
def fake_world_cell():
    """qwen1.5-0.5b × decode_32k on the fake 256-rank world, with a real
    reduced forward before and after it in this process; the world is torn
    down afterwards."""
    import torch.distributed as dist

    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.arange(2 * 12, dtype=torch.int64).reshape(2, 12) % cfg.vocab_size
    with torch.no_grad():
        before = model.forward(params, {"tokens": tokens})[0]
    try:
        frac = dryrun.per_rank_fraction()
        rec = dryrun.run_cell(tspecs.get_cell("qwen1.5-0.5b", "decode_32k"),
                              multi_pod=False, save=False)
        with torch.no_grad():
            after = model.forward(params, {"tokens": tokens})[0]
        yield {"rec": rec, "frac": frac, "before": before, "after": after}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_counter_counts_each_ranks_local_shards(fake_world_cell):
    assert fake_world_cell["frac"] == 1 / 16


def test_run_cell_decode_at_published_width(fake_world_cell):
    rec = fake_world_cell["rec"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cuda_initialized"] is False and not torch.cuda.is_initialized()
    assert rec["mesh"] == "data=16xmodel=16" and rec["chips"] == 256
    assert rec["route"] == "eager"
    assert rec["flops_counter"] == "FlopCounterMode"
    assert rec["bytes_counter"] == "aten operands+outputs, eager"
    ref_keys = {f.name for f in dataclasses.fields(janalysis.Roofline)} | {
        "arch", "shape", "mesh", "chips", "kind", "status", "compile_s", "param_bytes"}
    assert ref_keys <= set(rec)
    # a decode step's FLOPs are its weights' products: a device's share of the
    # model's 2·N·B (+ the KV reads), within the replicated norms' slack
    assert rec["flops_per_device"] * rec["chips"] == pytest.approx(rec["model_flops"], rel=1e-3)
    assert rec["bottleneck"] == "memory"
    assert rec["collectives"]["counts"]["all-reduce"] > 0


def test_real_forward_after_a_dry_run_is_bitwise_unchanged(fake_world_cell):
    assert torch.equal(fake_world_cell["after"], fake_world_cell["before"])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "moonshot_v1_16b_a3b", "mamba2_1_3b"])
def test_knobs_set_leave_a_one_device_forward_bitwise(arch):
    cfg = tconfigs.get_reduced(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.arange(2 * 12, dtype=torch.int64).reshape(2, 12) % cfg.vocab_size
    with torch.no_grad():
        want = model.forward(params, {"tokens": tokens})[0]
    tlayers.configure_shard_hints(("pod", "data", "model"))
    ttransformer.set_seq_parallel(True)
    ttransformer.set_layer_unroll(2)
    tmoe.set_capacity_sharding(True)
    try:
        x = torch.ones(3)
        assert tlayers.shard_hint(x, tlayers.DP, None) is x
        with torch.no_grad():
            got = model.forward(params, {"tokens": tokens})[0]
    finally:
        tlayers.configure_shard_hints(())
        ttransformer.set_seq_parallel(False)
        ttransformer.set_layer_unroll(1)
        tmoe.set_capacity_sharding(False)
    assert torch.equal(got, want)


def test_qaoa_cli_in_a_subprocess(tmp_path):
    """``python -m repro_torch.launch.dryrun --qaoa``'s entry point (its
    records sent to ``tmp_path``): both schedules at 30 qubits over the
    fake world's 16-way `model` groups, the plain route."""
    code = (f"import sys; from repro_torch.launch import dryrun; "
            f"dryrun.RESULTS_DIR = {str(tmp_path)!r}; dryrun.main(['--qaoa'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                                  OMP_NUM_THREADS="1"), timeout=400)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    import json

    for schedule in ("faithful", "alternating"):
        rec = json.loads((tmp_path / f"paraqaoa__qaoa_{schedule}__singlepod.json").read_text())
        assert rec["status"] == "ok" and rec["cuda_initialized"] is False
        assert rec["shape"] == "sharded_statevector_30q" and rec["route"] == "plain"
        assert rec["model_flops"] == 3 * 2**30 * (2 * 128 + 8.0)
        assert rec["collectives"]["counts"]["all-to-all"] > 0
        assert np.isfinite(rec["memory_s"]) and rec["bottleneck"] == "memory"


def test_lm_examples_run_on_the_cpu_and_default_to_cuda(monkeypatch, capsys):
    """``examples/serve_lm.py`` and ``examples/train_lm.py`` as the port's
    ``repro_torch.examples``: greedy generation, a falling loss, and CUDA
    unless ``--device`` says otherwise."""
    from repro_torch.examples import serve_lm, train_lm

    out = serve_lm.main(["--device", "cpu", "--new-tokens", "6"])
    assert tuple(out.shape) == (4, 6)
    losses = train_lm.main(["--steps", "12", "--log-every", "4", "--device", "cpu"])
    assert losses[-1] < losses[0]
    assert "serving OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serve_lm.main, train_lm.main):
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--steps", "2"] if main is train_lm.main else [])
