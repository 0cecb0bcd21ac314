"""The port's trainer (``repro_torch.training``, the remat policies of
``repro_torch.models.transformer``) against the JAX package's on the CPU,
at the reduced configs with B ≤ 2, S ≤ 32.

States cross over with ``convert.train_state_from_arrays``; every other
input is drawn from a numpy seed or from the shared data pipeline.
Tolerances, all f32:
- the optimizer: updated params, ``mu`` and ``nu`` within rtol 1e-6, atol
  1e-7 (the same arithmetic, ulps apart where either side fuses a
  multiply-add);
- one train step: loss, ``ce``, ``aux``, ``grad_norm`` and ``lr`` within
  rtol 1e-5; each gradient within 1e-6 + 1e-4·max|g| of its reference leaf
  (measured: at most 0.022 of that); the params after it within 1e-6 plus
  what the two gradients' difference moves Adam's first, normalised step
  g/(|g| + eps) (at |g| near eps = 1e-8 an ulp of g moves it by up to lr);
  where the gradients differ in sign (±lr apart), |g| ≤ 1e-6·max|g|;
- the whole trainer, 10 steps of reduced qwen: each step's loss within
  LOSS_BAND (relative) of the reference's;
- the patches and frames of the data pipeline: within 1e-5·|x| + 1e-6
  (torch's erfinv against XLA's; measured 4.6e-6 relative);
- everything else, the threefry bits, the tokens, the int8 compression, the
  remat policies against remat off and a restart against a straight run,
  bitwise.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import build_model as jbuild
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import reference_leaf
from repro_torch.training import checkpoint as TC
from repro_torch.training import data as TD
from repro_torch.training import fault_tolerance as TF
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TT

FAMILIES = ["qwen1_5_0_5b", "moonshot_v1_16b_a3b", "mamba2_1_3b", "zamba2_2_7b",
            "internvl2_2b", "whisper_medium"]
POLICIES = ["batch_dots", "dots", "everything", "off"]
LR = 1e-3
LOSS_BAND = 1e-3  # measured drift over 10 steps: below 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _remat_default():
    yield
    T.set_remat_policy("batch_dots")


def tree(x):
    return jax.tree.map(np.asarray, x)


def state_tree(state) -> dict:
    """A JAX ``TrainState`` nested as its checkpoint names it."""
    return {"params": tree(state.params),
            "opt": {"step": np.asarray(state.opt.step), "mu": tree(state.opt.mu),
                    "nu": tree(state.opt.nu)},
            "ef": None if state.ef is None else tree(state.ef)}


def as_torch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jtcfg(**kw):
    return JT.TrainConfig(adamw=JO.AdamWConfig(learning_rate=LR, warmup_steps=0,
                                               total_steps=100), remat=False, **kw)


def ttcfg(remat=False, **kw):
    return TT.TrainConfig(adamw=TO.AdamWConfig(learning_rate=LR, warmup_steps=0,
                                               total_steps=100), remat=remat, **kw)


def leaf_max(flat: dict) -> dict:
    """max |x| of each reference leaf of port-named arrays."""
    out = {}
    for name, a in flat.items():
        leaf = reference_leaf(name)
        out[leaf] = max(out.get(leaf, 0.0), float(np.abs(a).max()))
    return out


def named(params) -> dict:
    return {n: p.detach().numpy() for n, p in params.named_parameters()}


# ------------------------------------------------------------- optimizer --
def test_decay_mask_is_the_reference_leaf_rank():
    """``ndim >= 2`` of the reference's leaf: a per-layer 1-D leaf is a row
    of a stacked (L, d) leaf there, so it decays; ``final_norm`` does not."""
    cfg = tconfigs.get_reduced("mamba2_1_3b")
    shapes = tbuild(cfg).param_shapes()
    mask = {n: TO.decays(n, torch.empty(s, device="meta")) for n, (s, _) in shapes.items()}
    jshapes = jax.tree.map(lambda s: s.shape, jbuild(jconfigs.get_reduced("mamba2_1_3b"))
                           .param_shapes())
    for name, shape in convert.flatten(jshapes).items():
        want = len(shape) >= 2
        ports = [n for n in mask if reference_leaf(n) == name]
        assert ports and all(mask[n] == want for n in ports), name
    assert mask["blocks.0.ln1.scale"] and mask["blocks.3.ssm.a_log"]
    assert not mask["final_norm.scale"]


def test_optimizer_apply_matches_reference():
    """Two AdamW updates from a mid-run state (step 5, random moments), with
    weight decay 0.1 through the reference's mask, clipping engaged and a
    warmup-then-cosine schedule: the same params, moments, norm and lr."""
    rng = np.random.default_rng(0)
    jcfg = jconfigs.get_reduced("qwen1_5_0_5b")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    ocfg = dict(learning_rate=3e-3, weight_decay=0.1, clip_norm=1.0, warmup_steps=6,
                total_steps=20)

    def draw(scale, positive=False):
        def f(p):
            x = rng.standard_normal(p.shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(f, tree(jp))

    mu, nu = draw(0.01), draw(1e-4, positive=True)
    jstate = JO.AdamWState(step=jnp.int32(5), mu=mu, nu=nu)
    tstate = convert.train_state_from_arrays(
        tconfigs.get_reduced("qwen1_5_0_5b"),
        {"params": tree(jp), "opt": {"step": 5, "mu": mu, "nu": nu}}).opt
    tparams = convert.model_params_from_arrays(tconfigs.get_reduced("qwen1_5_0_5b"), tree(jp))
    tp = dict(tparams.named_parameters())
    jparams = jp
    japply = jax.jit(JO.apply, static_argnums=0)
    for _ in range(2):
        grads = draw(0.5)
        jparams, jstate, jm = japply(JO.AdamWConfig(**ocfg), jparams, grads, jstate)
        tg = {n: torch.from_numpy(a) for n, a in convert.unstack_layers(grads).items()}
        tp, tstate, tm = TO.apply(TO.AdamWConfig(**ocfg), tp, tg, tstate)
        assert float(jm["grad_norm"]) > 1.0  # clipping engaged
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert int(tstate.step) == int(jstate.step)
        for got, want in ((tp, jparams), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            want = convert.unstack_layers(tree(want))
            assert got.keys() == want.keys()
            for n, w in want.items():
                np.testing.assert_allclose(got[n].detach().numpy(), w, rtol=1e-6, atol=1e-7,
                                           err_msg=n)
    # the reference decays the stacked norm scale blocks/ln1/scale (L, d):
    # lr·wd·scale ≈ 1.5e-4 a step, far outside the tolerance, so the port's
    # (d,) blocks.i.ln1.scale matched only through its decay
    assert TO.decays("blocks.0.ln1.scale", tp["blocks.0.ln1.scale"])


def test_schedule_matches_reference():
    cfg = dict(learning_rate=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        want = float(JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step)))
        assert TO.schedule(TO.AdamWConfig(**cfg), step) == pytest.approx(want, rel=1e-6)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[1, 3:] = -1
    for z in (0.0, 1e-4):
        want = float(JT.cross_entropy(logits, labels, z))
        got = float(TT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z))
        assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------ train step --
@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The reference's step from its init on step 0's batch: the loss's
    gradients under ``jax.value_and_grad``, then ``optimizer.apply``, the
    two halves of ``train_step``, in one jit."""
    cfg = jconfigs.get_reduced(arch)
    model = jbuild(cfg)
    tcfg = jtcfg()
    state = JT.init_state(model, jax.random.PRNGKey(0), tcfg)
    batch = JD.synthetic_batch(cfg, JD.DataConfig(seed=3, batch=2, seq=32), 0)

    @jax.jit
    def step(state, batch):
        (loss, parts), grads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
            state.params, batch, model, tcfg)
        params, _, om = JO.apply(tcfg.adamw, state.params, grads, state.opt)
        return grads, params, {"loss": loss, **parts, **om}

    grads, params, metrics = step(state, batch)
    return (state_tree(state), tree(batch), convert.unstack_layers(tree(grads)),
            convert.unstack_layers(tree(params)), {k: float(v) for k, v in metrics.items()})


def step1_delta(g: np.ndarray, scale: float, cfg: TO.AdamWConfig) -> np.ndarray:
    """Adam's first normalised step of the clipped gradient, in float64."""
    g = g.astype(np.float64) * scale
    m = (1 - cfg.beta1) * g / (1 - cfg.beta1)
    v = (1 - cfg.beta2) * g * g / (1 - cfg.beta2)
    return m / (np.sqrt(v) + cfg.eps)


def hold_step(arch, policy):
    jstate, batch, jgrads, jparams, jm = _jax_step(arch)
    tcfg = tconfigs.get_reduced(arch)
    model = tbuild(tcfg)
    T.set_remat_policy(policy)
    cfg = ttcfg(remat=True)
    state = convert.train_state_from_arrays(tcfg, jstate)
    _, _, tgrads = TT.value_and_grad(state.params, as_torch(batch), model, cfg)
    state, tm = TT.train_step(state, as_torch(batch), model, cfg)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(jm[k], rel=1e-5, abs=1e-7), k

    gmax = leaf_max(jgrads)
    for n, want in jgrads.items():
        got = tgrads[n].numpy()
        tol = 1e-6 + 1e-4 * gmax[reference_leaf(n)]
        assert np.abs(got - want).max() <= tol, (n, np.abs(got - want).max(), tol)

    lr, flips = tm["lr"], 0
    scale_t = min(1.0, 1.0 / (float(tm["grad_norm"]) + 1e-9))
    scale_j = min(1.0, 1.0 / (jm["grad_norm"] + 1e-9))
    after = named(state.params)
    for n, want in jparams.items():
        got, gt, gj = after[n], tgrads[n].numpy(), jgrads[n]
        flip = np.sign(gt) != np.sign(gj)
        flips += int(flip.sum())
        assert (np.abs(gj[flip]) <= 1e-6 * gmax[reference_leaf(n)]).all(), n
        moved = np.abs(step1_delta(gt, scale_t, cfg.adamw) - step1_delta(gj, scale_j, cfg.adamw))
        err = np.abs(got - want)
        assert (err <= 1e-6 + lr * moved * (1 + 1e-3)).all(), (n, err.max())
    return flips


@pytest.mark.parametrize("policy", ["off", "batch_dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, policy):
    """One step from the same converted state on the same batch, for each
    family (dense, MoE with its aux loss, SSM, hybrid, VLM, audio); the
    elements whose gradients differ in sign are counted (at most a few a
    model; each |g| ≤ 1e-6·max|g|)."""
    assert hold_step(arch, policy) <= 8


def test_trains_after_a_forward_in_inference_mode():
    """RoPE's cached tables first built under ``inference_mode`` (a
    generate) must not break a later backward in the same process."""
    from repro_torch.models import layers as TL

    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    model = tbuild(cfg)
    params = model.init(0, device="cpu")
    batch = TD.synthetic_batch(cfg, TD.DataConfig(batch=2, seq=8), 0)
    TL._rope_tables.cache_clear()
    with torch.inference_mode():
        model.forward(params, batch)
    loss, _, grads = TT.value_and_grad(params, batch, model, ttcfg(remat=True))
    assert torch.isfinite(loss) and torch.isfinite(grads["blocks.0.attn.wq"]).all()


def test_set_remat_policy_takes_the_reference_names():
    with pytest.raises(AssertionError):
        T.set_remat_policy("dots_saveable")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "moonshot_v1_16b_a3b", "zamba2_2_7b"])
def test_remat_gradients_bitwise(arch, policy):
    """Each policy's gradients equal remat off's bit for bit (the CPU
    recomputes the same ops on the same inputs)."""
    cfg = tconfigs.get_reduced(arch)
    model = tbuild(cfg)
    params = model.init(0, device="cpu")
    batch = TD.synthetic_batch(cfg, TD.DataConfig(seed=1, batch=2, seq=24), 0)
    T.set_remat_policy("off")
    want = TT.value_and_grad(params, batch, model, ttcfg(remat=True))
    T.set_remat_policy(policy)
    got = TT.value_and_grad(params, batch, model, ttcfg(remat=True))
    assert torch.equal(got[0], want[0])
    for n, g in want[2].items():
        assert torch.equal(got[2][n], g), n


def _count_saved(monkeypatch, policy):
    """(tensors autograd saves outside any checkpoint, products the
    selective policy keeps) for one forward of a reduced qwen block."""
    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    params = tbuild(cfg).init(0, device="cpu")
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    kept = []
    orig = T.create_selective_checkpoint_contexts

    def counting(policy_fn, *a, **kw):
        def spy(ctx, op, *args, **kwargs):
            out = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and out == T.CheckpointPolicy.MUST_SAVE:
                kept.append((str(op), T._dot_batch(op, args)))
            return out
        return orig(spy, *a, **kw)

    monkeypatch.setattr(T, "create_selective_checkpoint_contexts", counting)
    T.set_remat_policy(policy)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = T._attn_stack(params, x, cfg, remat=True).x
    out.sum().backward()
    return len(saved), kept


def test_remat_saves_per_policy(monkeypatch):
    """One reduced qwen block a layer, four layers: ``off`` saves every
    activation autograd needs; under a checkpoint only each layer's input is
    saved outside it; ``dots`` keeps every product (q, k, v, the scores, the weighted sum,
    wo, gate, up, down: 9 a layer) and ``batch_dots`` the 7 with no batch
    dimension (the scores and the weighted sum are batched over B x KV
    groups), each told apart by its batch size (einsum's q/k/v/wo products
    are bmm with a batch of 1)."""
    n_layers = tconfigs.get_reduced("qwen1_5_0_5b").n_layers
    off, kept = _count_saved(monkeypatch, "off")
    assert off > 20 * n_layers and kept == []
    for policy, per_layer in (("everything", 0), ("dots", 9), ("batch_dots", 7)):
        outside, kept = _count_saved(monkeypatch, policy)
        assert outside == n_layers, policy
        assert len(kept) == per_layer * n_layers, (policy, kept)
        batched = [b for _, b in kept if b > 1]
        assert len(batched) == (2 * n_layers if policy == "dots" else 0)
    assert any("bmm" in op for op, b in kept if b == 1)  # einsum's batch-1 bmm kept


# ------------------------------------------------------------------ int8 --
def test_int8_compression_bitwise():
    """The same gradients and residuals through both, the reference jitted
    as its trainer runs it: bitwise, with one scale a stacked leaf (a
    per-layer scale would differ)."""
    rng = np.random.default_rng(2)
    jp = tree(jbuild(jconfigs.get_reduced("qwen1_5_0_5b")).init(jax.random.PRNGKey(0)))
    draw = lambda s: jax.tree.map(  # noqa: E731
        lambda p: (rng.standard_normal(p.shape) * s * rng.uniform(0.1, 10)).astype(np.float32), jp)
    grads, ef = draw(1.0), draw(0.01)
    jg, je = jax.jit(JT._compress_int8)(grads, ef)
    t = lambda d: {n: torch.from_numpy(a) for n, a in convert.unstack_layers(d).items()}  # noqa: E731
    tg, te = TT._compress_int8(t(grads), t(ef))
    for got, want in ((tg, jg), (te, je)):
        for n, w in convert.unstack_layers(tree(want)).items():
            assert np.array_equal(got[n].numpy(), w), n


def test_int8_compression_converges_like_uncompressed():
    """The reference's check (tests/test_fault_tolerance.py): 12 steps at
    lr 3e-3, both curves fall and end within 5% of each other."""
    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    model = tbuild(cfg)
    dcfg = TD.DataConfig(seed=3, batch=2, seq=32)
    curves = {}
    for comp in ("none", "int8"):
        tcfg = TT.TrainConfig(adamw=TO.AdamWConfig(learning_rate=3e-3, warmup_steps=0,
                                                   total_steps=100),
                              remat=False, grad_compression=comp)
        state = TT.init_state(model, 0, tcfg, "cpu")
        losses = []
        for step in range(12):
            state, m = TT.train_step(state, TD.synthetic_batch(cfg, dcfg, step), model, tcfg)
            losses.append(float(m["loss"]))
        curves[comp] = losses
    plain, comp = curves["none"], curves["int8"]
    assert plain[-1] < plain[0] and comp[-1] < comp[0]
    assert abs(plain[-1] - comp[-1]) / plain[-1] < 0.05, (plain[-1], comp[-1])


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (123, 1000), (2**31 - 1, 5)])
def test_threefry_bits_bitwise(seed, step):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    tk = TD.fold_in(TD.prng_key(seed), step)
    assert np.array_equal(np.asarray(jk, np.int64), tk.numpy())
    js, ts = jax.random.split(jk, 4), TD.split(tk, 4)
    assert np.array_equal(np.asarray(js, np.int64), ts.numpy())
    jb = jax.random.bits(js[0], (3, 17), jnp.uint32)
    assert np.array_equal(np.asarray(jb, np.int64), TD.random_bits(ts[0], (3, 17)).numpy())
    ju = jax.random.uniform(js[0], (3, 17))
    assert np.array_equal(np.asarray(ju), TD.uniform(ts[0], (3, 17)).numpy())


@pytest.mark.parametrize("vocab", [None, 151_936])
def test_tokens_equal_reference(vocab):
    """Tokens and labels bitwise at the reduced vocab (512) and at qwen's
    151,936, over 20 steps of 8 x 128 (20,480 draws each)."""
    import dataclasses

    jcfg, tcfg = jconfigs.get_reduced("qwen1_5_0_5b"), tconfigs.get_reduced("qwen1_5_0_5b")
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        tcfg = dataclasses.replace(tcfg, vocab_size=vocab)
    for step in range(20):
        want = JD.synthetic_batch(jcfg, JD.DataConfig(seed=1, batch=8, seq=128), step)
        got = TD.synthetic_batch(tcfg, TD.DataConfig(seed=1, batch=8, seq=128), step)
        assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"])), step
        assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"])), step


def test_labels_shift_and_host_slicing():
    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    a = TD.synthetic_batch(cfg, TD.DataConfig(seed=1, batch=4, seq=8), 3)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == 0).all()
    assert torch.equal(a["tokens"], TD.synthetic_batch(cfg, TD.DataConfig(seed=1, batch=4, seq=8),
                                                       3)["tokens"])
    parts = [TD.synthetic_batch(cfg, TD.DataConfig(seed=1, batch=4, seq=8, host_id=h, n_hosts=2), 3)
             for h in range(2)]
    for k in ("tokens", "labels"):
        assert torch.equal(torch.cat([p[k] for p in parts]), a[k])
    it = TD.iterate(cfg, TD.DataConfig(seed=1, batch=4, seq=8), start_step=3)
    step, b = next(it)
    assert step == 3 and torch.equal(b["tokens"], a["tokens"])


@pytest.mark.parametrize("arch,key", [("internvl2_2b", "patches"), ("whisper_medium", "frames")])
def test_patches_and_frames_within_tolerance(arch, key):
    want = JD.synthetic_batch(jconfigs.get_reduced(arch), JD.DataConfig(seed=2, batch=2, seq=16), 4)
    got = TD.synthetic_batch(tconfigs.get_reduced(arch), TD.DataConfig(seed=2, batch=2, seq=16), 4)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- checkpointing --
def _small_state(compression="none"):
    cfg = tconfigs.get_reduced("qwen1_5_0_5b")
    model = tbuild(cfg)
    tcfg = ttcfg(grad_compression=compression)
    return cfg, model, tcfg, TT.init_state(model, 0, tcfg, "cpu")


def test_checkpoint_roundtrip(tmp_path):
    cfg, model, tcfg, state = _small_state("int8")
    state, _ = TT.train_step(state, TD.synthetic_batch(cfg, TD.DataConfig(batch=2, seq=16), 0),
                             model, tcfg)
    ckpt = TC.CheckpointManager(str(tmp_path), async_write=False)
    ckpt.save(7, state, {"note": "x"})
    assert ckpt.latest_step() == 7
    _, _, _, fresh = _small_state("int8")
    fresh = TT.TrainState(TT.init_state(model, 1, tcfg, "cpu").params, fresh.opt, fresh.ef)
    step, restored, extra = ckpt.restore(fresh)
    assert step == 7 and extra == {"step": 7, "note": "x"}
    want, got = TC._flatten(state), TC._flatten(restored)
    assert want.keys() == got.keys() and "params/blocks/0/attn/wq" in want
    assert "opt/step" in want and "ef/blocks/3/mlp/w_up" in want
    for k in want:
        assert np.array_equal(want[k], got[k]), k


def test_checkpoint_ignores_partial_write(tmp_path):
    """A leftover .tmp dir (a crash mid-write) is not a checkpoint, and a
    later save of the same step succeeds."""
    _, _, _, state = _small_state()
    ckpt = TC.CheckpointManager(str(tmp_path), async_write=False)
    os.makedirs(tmp_path / ".tmp-5")
    (tmp_path / ".tmp-5" / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step() is None
    ckpt.save(5, state)
    assert ckpt.latest_step() == 5
    ckpt.restore(state)


def test_async_writer_records_state_at_save(tmp_path):
    """A step after ``save`` updates the parameters in place; the written
    checkpoint holds them as they were at ``save``."""
    cfg, model, tcfg, state = _small_state()
    before = TC._flatten(state)
    ckpt = TC.CheckpointManager(str(tmp_path), async_write=True)
    ckpt.save(1, state)
    state, _ = TT.train_step(state, TD.synthetic_batch(cfg, TD.DataConfig(batch=2, seq=16), 0),
                             model, tcfg)
    ckpt.save(2, state)
    ckpt.wait()
    assert ckpt.latest_step() == 2
    _, flat, _ = ckpt.read(1)
    after = TC._flatten(state)
    changed = 0
    for k, want in before.items():
        assert np.array_equal(flat[k], want), k
        changed += not np.array_equal(want, after[k])
    assert changed > 10


def test_retention(tmp_path):
    _, _, _, state = _small_state()
    ckpt = TC.CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, state)
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert steps == [3, 4]


def test_crash_restart_bitwise(tmp_path):
    """6 steps straight = 3 steps, a save, a "crash", `resume_or_init` and 3
    more: the params, moments and losses bit for bit."""
    cfg, model, tcfg, _ = _small_state()
    dcfg = TD.DataConfig(seed=3, batch=2, seq=32)

    def steps(state, lo, hi):
        losses = []
        for s in range(lo, hi):
            state, m = TT.train_step(state, TD.synthetic_batch(cfg, dcfg, s), model, tcfg)
            losses.append(float(m["loss"]))
        return state, losses

    def init():
        return TT.init_state(model, 0, tcfg, "cpu")

    a, losses_a = steps(init(), 0, 6)
    ckpt = TC.CheckpointManager(str(tmp_path))
    b, _ = steps(init(), 0, 3)
    ckpt.save(3, b)
    ckpt.wait()
    del b  # "crash"
    start, c, resumed = TF.resume_or_init(ckpt, init)
    assert resumed and start == 3 and int(c.opt.step) == 3
    c, losses_c = steps(c, 3, 6)
    assert losses_a[3:] == losses_c
    want, got = TC._flatten(a), TC._flatten(c)
    for k in want:
        assert np.array_equal(want[k], got[k]), k


def test_reads_a_checkpoint_the_reference_wrote(tmp_path):
    """The JAX ``CheckpointManager`` writes its state after one step (int8
    residuals included); the port reads it through
    ``convert.train_state_from_arrays`` and both take the next step on the
    same batch to the same loss."""
    arch = "qwen1_5_0_5b"
    jcfg = jconfigs.get_reduced(arch)
    jm = jbuild(jcfg)
    jt = jtcfg(grad_compression="int8")
    dcfg = JD.DataConfig(seed=3, batch=2, seq=16)
    js = JT.init_state(jm, jax.random.PRNGKey(0), jt)
    step_fn = jax.jit(lambda s, b: JT.train_step(s, b, jm, jt))
    js, _ = step_fn(js, JD.synthetic_batch(jcfg, dcfg, 0))
    jck = JC.CheckpointManager(str(tmp_path), async_write=False)
    jck.save(1, js)

    step, flat, _ = TC.CheckpointManager(str(tmp_path), async_write=False).read()
    state = convert.train_state_from_arrays(tconfigs.get_reduced(arch), TC.nest(flat))
    assert step == 1 and int(state.opt.step) == 1 and state.ef is not None
    want = convert.unstack_layers(tree(js.opt.nu))
    for n, w in want.items():
        assert np.array_equal(state.opt.nu[n].numpy(), w), n
    assert np.array_equal(state.params.blocks[2].attn.wq.detach().numpy(),
                          np.asarray(js.params["blocks"]["attn"]["wq"][2]))
    js2, jm2 = step_fn(js, JD.synthetic_batch(jcfg, dcfg, 1))
    tcfg = ttcfg(grad_compression="int8")
    _, tm2 = TT.train_step(state, TD.synthetic_batch(tconfigs.get_reduced(arch),
                                                     TD.DataConfig(seed=3, batch=2, seq=16), 1),
                           tbuild(tconfigs.get_reduced(arch)), tcfg)
    assert float(tm2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)


def test_reshard_state_places_on_device():
    _, _, _, state = _small_state("int8")
    moved = TF.reshard_state(state, "cpu")
    assert moved.params is state.params and moved.opt.step is state.opt.step
    assert moved.opt.mu.keys() == state.opt.mu.keys() and moved.ef.keys() == state.ef.keys()
    assert all(t.device.type == "cpu" for t in moved.opt.nu.values())


# ------------------------------------------------------------- heartbeat --
def test_heartbeat_detects_stall():
    stalls = []
    mon = TF.HeartbeatMonitor(timeout_s=0.3, on_stall=stalls.append)
    mon.beat(1)
    time.sleep(0.8)
    assert mon.stalled and stalls == [1]
    mon.stop()


def test_heartbeat_no_false_positive():
    mon = TF.HeartbeatMonitor(timeout_s=0.5)
    for i in range(5):
        mon.beat(i)
        time.sleep(0.1)
    assert not mon.stalled
    mon.stop()


# ---------------------------------------------------------- whole trainer --
def test_ten_steps_within_band_of_reference():
    """10 steps of reduced qwen from one converted state, each side drawing
    its batches with its own ``synthetic_batch`` and rematerialising under
    ``batch_dots`` (the trainer's default): every loss within LOSS_BAND."""
    arch = "qwen1_5_0_5b"
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    adamw = dict(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    jm = jbuild(jcfg)
    jt = JT.TrainConfig(adamw=JO.AdamWConfig(**adamw), remat=True)
    js = JT.init_state(jm, jax.random.PRNGKey(0), jt)
    state = convert.train_state_from_arrays(tcfg, state_tree(js))
    step_fn = jax.jit(lambda s, b: JT.train_step(s, b, jm, jt))
    model, cfg = tbuild(tcfg), TT.TrainConfig(adamw=TO.AdamWConfig(**adamw), remat=True)
    want, got = [], []
    for step in range(10):
        js, m = step_fn(js, JD.synthetic_batch(jcfg, JD.DataConfig(seed=0, batch=2, seq=32), step))
        want.append(float(m["loss"]))
        state, tm = TT.train_step(
            state, TD.synthetic_batch(tcfg, TD.DataConfig(seed=0, batch=2, seq=32), step),
            model, cfg)
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_BAND)
    assert want[-1] < want[0] and got[-1] < got[0]
