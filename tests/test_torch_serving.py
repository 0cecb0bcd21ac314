"""The port's serve path (``repro_torch.serving.engine``,
``repro_torch.launch.serve``) against the JAX package's on the CPU.

Greedy generation is held against the JAX ``Engine`` on the same weights:
tokens equal wherever the JAX top-2 margin exceeds ``MARGIN`` (past a
closer call either framework may pick the other token, and then the two
continue from different prefixes), and the port's step logits within
``atol 1e-5, rtol 1e-4`` of the JAX ones when fed the JAX tokens.
``jax.random.categorical`` cannot be matched bit for bit, so temperature
sampling is held to determinism per seed and to a change from greedy, as
``tests/test_serving.py`` holds the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jcli
from repro.models.model import build_model as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tcli
from repro_torch.models.model import build_model as tbuild
from repro_torch.serving.engine import Engine, ServeConfig

ATOL, RTOL = 1e-5, 1e-4
MARGIN = 2 * ATOL  # a top-2 gap either framework's error could close


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(arch, seed=0):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = convert.model_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _prompts(cfg, bsz, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)


def _jax_step_logits(jm, jp, prompts, gen_tokens):
    """The JAX logits that chose each generated token, teacher-forced:
    (B, new tokens, V)."""
    n = gen_tokens.shape[1]
    logits, state = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                               s_max=prompts.shape[1] + n + 1)
    out = [np.asarray(logits[:, 0])]
    for i in range(n - 1):
        logits, state = jm.decode_step(jp, jnp.asarray(gen_tokens[:, i]), state)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def _port_step_logits(tm, tp, prompts, gen_tokens):
    n = gen_tokens.shape[1]
    with torch.no_grad():
        logits, state = tm.prefill(tp, {"tokens": torch.from_numpy(prompts).long()},
                                   prompts.shape[1] + n + 1)
        out = [logits[:, 0]]
        for i in range(n - 1):
            logits, state = tm.decode_step(
                tp, torch.from_numpy(np.array(gen_tokens[:, i])).long(), state)
            out.append(logits)
    return torch.stack(out, dim=1).numpy()


def _decided(logits):
    """(B, n) True where the top-2 gap exceeds MARGIN, and False from a
    row's first closer call on."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    return np.cumprod(clear, axis=1).astype(bool)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mamba2_1_3b", "zamba2_2_7b"])
def test_greedy_generation_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(tm.cfg, 2, 8)
    jout = JEngine(jm, jp, JServeConfig(max_new_tokens=6)).generate(
        {"tokens": jnp.asarray(prompts)})
    tout = Engine(tm, tp, ServeConfig(max_new_tokens=6), device="cpu").generate(
        {"tokens": prompts})
    assert tout.shape == jout.shape == (2, 6)

    jl = _jax_step_logits(jm, jp, prompts, jout)
    np.testing.assert_allclose(_port_step_logits(tm, tp, prompts, jout), jl,
                               atol=ATOL, rtol=RTOL)
    decided = _decided(jl)
    assert decided[:, 0].all()  # the seeded prompts leave no first-step tie
    assert np.array_equal(tout[decided], jout[decided])

    # the port's own invariant: the first token is argmax of its forward
    with torch.no_grad():
        logits, _ = tm.forward(tp, {"tokens": torch.from_numpy(prompts).long()})
    assert np.array_equal(tout[:, 0], logits[:, -1].argmax(-1).numpy())


def test_eos_early_exit_matches_reference():
    """Both rows share a prompt, so both repeat its first greedy token; with
    that token as EOS every row is done after the first decode step, and
    generation stops there in both frameworks (the first sampled token
    does not count towards ``done``, as in the reference)."""
    jm, jp, tm, tp = _pair("qwen1_5_0_5b")
    prompts = np.repeat(_prompts(tm.cfg, 1, 4), 2, axis=0)
    first = Engine(tm, tp, ServeConfig(max_new_tokens=8), device="cpu").generate(
        {"tokens": prompts})
    eos = int(first[0, 0])
    assert (first == eos).all()
    tout = Engine(tm, tp, ServeConfig(max_new_tokens=8, eos_id=eos),
                  device="cpu").generate({"tokens": prompts})
    jout = JEngine(jm, jp, JServeConfig(max_new_tokens=8, eos_id=eos)).generate(
        {"tokens": jnp.asarray(prompts)})
    assert tout.shape == jout.shape == (2, 2)
    assert (tout == eos).all()


def test_eos_marks_finished_rows():
    """A row that emits EOS keeps emitting it while the others run on."""
    _, _, tm, tp = _pair("qwen1_5_0_5b")
    prompts = _prompts(tm.cfg, 2, 4)
    greedy = Engine(tm, tp, ServeConfig(max_new_tokens=8), device="cpu").generate(
        {"tokens": prompts})
    eos = int(greedy[0, 1])
    out = Engine(tm, tp, ServeConfig(max_new_tokens=8, eos_id=eos),
                 device="cpu").generate({"tokens": prompts})
    assert out.shape[1] <= 8
    hit = np.argmax(out[0] == eos)
    assert (out[0, max(hit, 1):] == eos).all()


def test_temperature_sampling():
    _, _, tm, tp = _pair("qwen1_5_0_5b")
    prompts = {"tokens": _prompts(tm.cfg, 4, 8)}

    def gen(**kw):
        return Engine(tm, tp, ServeConfig(max_new_tokens=8, **kw),
                      device="cpu").generate(prompts)

    greedy = gen()
    hot = gen(temperature=5.0, seed=3)
    assert not np.array_equal(greedy, hot)
    assert np.array_equal(hot, gen(temperature=5.0, seed=3))
    assert not np.array_equal(hot, gen(temperature=5.0, seed=4))
    assert ((hot >= 0) & (hot < tm.cfg.vocab_size)).all()


def test_step_times_recorded():
    _, _, tm, tp = _pair("mamba2_1_3b")
    engine = Engine(tm, tp, ServeConfig(max_new_tokens=5), device="cpu")
    engine.generate({"tokens": _prompts(tm.cfg, 2, 4)})
    ms = engine.step_ms()
    assert ms["prefill_ms"] > 0 and len(ms["decode_ms"]) == 4
    assert all(t > 0 for t in ms["decode_ms"])


# ------------------------------------------------------------------- CLI --
def _flags(parser):
    return {a.dest: (a.option_strings, a.default) for a in parser._actions
            if a.dest != "help"}


def test_cli_flags_are_the_reference_ones_plus_device():
    j, t = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert t.pop("device") == (["--device"], "cuda")
    assert t == j


@pytest.mark.parametrize("argv,reduced", [
    ([], True), (["--full-size"], False), (["--reduced"], True),
    (["--reduced", "--full-size"], False), (["--full-size", "--reduced"], True),
])
def test_cli_reduced_full_size_pair(argv, reduced):
    args = tcli.build_parser().parse_args(["--arch", "qwen1.5-0.5b", *argv])
    assert args.reduced is reduced


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "whisper-medium"])
def test_cli_runs_on_cpu(arch, capsys):
    served = tcli.run(["--arch", arch, "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    name = tconfigs.get_reduced(arch).name
    assert len(lines) == 2
    assert lines[0].startswith(f"[serve] arch={name} generated (2, 5) in ")
    assert lines[0].endswith("tok/s on the CPU)")
    assert lines[1] == f"[serve] first rows: {served.tokens[:2, :12].tolist()}"
    assert served.tokens.shape == (2, 5)
    assert served.batch["tokens"].shape == (2, 6)
    assert len(served.engine.step_ms()["decode_ms"]) == 4


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_full_size_resolves_to_float32_published_widths(arch):
    """``--full-size``: the published config with only ``dtype`` set to its
    ``param_dtype``, checked on the meta-device parameter shapes (nothing
    allocated) against the reference's ``jax.eval_shape``."""
    args = tcli.build_parser().parse_args(["--arch", arch, "--full-size"])
    cfg, note = tcli.resolve_config(args.arch, args.reduced)
    published = tconfigs.get_config(arch)
    assert cfg.dtype == "float32" and published.dtype == "bfloat16"
    assert dataclasses.replace(cfg, dtype=published.dtype) == published
    assert "ROADMAP §3" in note and "published bfloat16" in note
    shapes = tbuild(cfg).param_shapes()
    assert {d for _, d in shapes.values()} == {torch.float32}
    n = sum(int(np.prod(s)) for s, _ in shapes.values())
    want = jax.tree.leaves(jbuild(jconfigs.get_config(arch)).param_shapes())
    assert n == sum(int(np.prod(leaf.shape)) for leaf in want)
    if arch == "qwen1.5-0.5b":
        assert shapes["embed.table"][0] == (151_936, 1024)
        assert shapes["blocks.23.attn.wq"][0] == (1024, 16, 64)
        assert 463e6 < n < 465e6  # ~1.86 GB in f32
    else:
        assert shapes["blocks.47.ssm.in_proj"][0] == (2048, 2 * 4096 + 2 * 128 + 64)
        assert 1.3e9 < n < 1.4e9


# -------------------------------------------------------- default device --
@pytest.mark.parametrize("entry", ["cli", "engine", "init", "decode_state"])
def test_serve_entry_points_default_to_cuda(monkeypatch, entry):
    """The serve CLI, the engine, ``Model.init`` and
    ``Model.init_decode_state`` raise where CUDA is missing."""
    _, _, tm, tp = _pair("qwen1_5_0_5b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {
        "cli": lambda: tcli.run(["--arch", "qwen1.5-0.5b", "--batch", "1",
                                 "--new-tokens", "2"]),
        "engine": lambda: Engine(tm, tp, ServeConfig(max_new_tokens=2)),
        "init": lambda: tm.init(0),
        "decode_state": lambda: tm.init_decode_state(1, 8),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        run()
