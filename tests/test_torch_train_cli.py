"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: the reference's flags plus ``--device``, the crash-and-resume loop, a
falling loss, the published config's float32 note, and no silent move to
the CPU."""

import pytest
import torch

from repro.launch import train as jcli
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tcli

ARGS = ["--arch", "qwen1_5_0_5b", "--reduced", "--batch", "2", "--seq", "16",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flags(parser):
    return {a.dest: (a.option_strings, a.default) for a in parser._actions
            if a.dest != "help"}


def _reference_flags():
    """The reference CLI's flags, read from its parser (it builds the parser
    inside ``run``): the parse is stopped before anything runs."""
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def stop(self, *a, **kw):
        seen.update(_flags(self))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = stop
    try:
        with pytest.raises(SystemExit):
            jcli.run([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_flags_are_the_reference_ones_plus_device():
    t = _flags(tcli.build_parser())
    assert t.pop("device") == (["--device"], "cuda")
    assert t == _reference_flags()
    args = tcli.build_parser().parse_args(["--arch", "x"])
    assert args.remat is True and args.reduced is False  # the reference's defaults


def test_dies_at_fail_step_and_resumes(tmp_path, capsys):
    """``--fail-at-step 5`` with a checkpoint every 2 steps: the run dies at
    step 5 with step-5's checkpoint written (steps 0-4 done); the rerun says
    it resumed from step 5, runs 5-7 and saves steps 7 and 8 (three kept)."""
    ckpt = str(tmp_path / "ck")
    args = ARGS + ["--steps", "8", "--ckpt-dir", ckpt, "--ckpt-every", "2",
                   "--log-every", "2"]
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        tcli.run(args + ["--fail-at-step", "5"])
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith("[train] arch=qwen1.5-0.5b ") and "on the CPU" in first[0]
    assert [ln.split()[2] for ln in first[1:]] == ["0", "2", "4"]
    out = tcli.run(args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "[train] resumed from step 5"
    assert out.start_step == 5 and int(out.state.opt.step) == 8
    assert [ln.split()[2] for ln in lines[2:-1]] == ["6", "7"]
    assert lines[-1].startswith("[train] done: first logged loss ")
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step-5", "step-7", "step-8"]
    assert len(out.step_ms) == 3 and all(ms > 0 for ms in out.step_ms)


def test_loss_falls_over_8_steps(capsys):
    out = tcli.run(ARGS + ["--steps", "8", "--log-every", "1", "--lr", "3e-3"])
    assert len(out.losses) == 8
    assert out.losses[-1] < out.losses[0]
    assert 5.5 < out.losses[0] < 7.0  # ~ln(512) at init


def test_published_config_runs_float32_and_says_so(monkeypatch, capsys):
    """Without ``--reduced``: the published config with ``dtype`` set to its
    ``param_dtype``, named on the first line (stopped before anything is
    allocated)."""
    class Stop(Exception):
        pass

    def stop(model, seed, tcfg, dev):
        assert model.cfg.dtype == "float32" and model.cfg.d_model == 1024
        raise Stop

    monkeypatch.setattr(tcli, "init_state", stop)
    with pytest.raises(Stop):
        tcli.run(["--arch", "qwen1.5-0.5b", "--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("[train] arch=qwen1.5-0.5b dtype=float32 (published bfloat16")
    assert "ROADMAP §3" in line and "463.9 M params" in line


def test_raises_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.run(["--arch", "qwen1_5_0_5b", "--reduced", "--steps", "1"])
    assert tconfigs.get_reduced("qwen1_5_0_5b").vocab_size == 512
