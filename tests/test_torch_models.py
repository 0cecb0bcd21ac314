"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the CPU, at the reduced configs.

The JAX parameters come from ``repro.models`` and are carried across with
``convert.model_params_from_arrays``; every input is drawn from a numpy
seed. Tolerance, all f32: ``atol 1e-5, rtol 1e-4`` (the two frameworks'
matmuls and transcendentals differ in the last ulps; measured differences
are ~5e-7 on logits of ~0.4). ``F.softplus`` returns x above 20 where
``jax.nn.softplus`` returns x + log1p(e^-x): within e^-20 relative, far
inside the tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.model import build_model as tbuild

ATOL, RTOL = 1e-5, 1e-4
TIE = 1e-5  # router probabilities this close count as a near-tie
ARCHS = jconfigs.lm_arch_ids()
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def t(a):
    return torch.from_numpy(np.array(a))


def tree(params):
    return jax.tree.map(np.asarray, params)


def port(module, jparams):
    """The port's ``module`` holding the JAX module's parameter arrays."""
    return convert.load_arrays(module, convert.flatten(tree(jparams)))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------- configs --
def test_config_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.lm_arch_ids() == jconfigs.lm_arch_ids()
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_reduced"):
            j = getattr(jconfigs, get)(arch)
            p = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(p) == dataclasses.asdict(j), (arch, get)
    for arch in ARCHS:
        j, p = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert p.layer_kinds() == j.layer_kinds()
        assert p.layer_windows() == j.layer_windows()
        assert p.n_params() == j.n_params()
        assert p.n_active_params() == j.n_active_params()
        assert p.pdtype == F32 and p.cdtype == torch.bfloat16
    assert tconfigs.canonical("mamba2-1.3b") == "mamba2_1_3b"


def test_mismatched_dtype_raises():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen1_5_0_5b"), dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype == param_dtype"):
        tbuild(cfg)
    with pytest.raises(ValueError):
        tbuild(tconfigs.get_config("mamba2_1_3b"))  # published: bf16 over f32


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "zamba2_2_7b"])
def test_reference_rejects_mixed_dtype(arch):
    """The reference fault the port's f32 choice follows from (ROADMAP §3):
    at ``dtype="bfloat16"`` over f32 parameters the first block's einsum
    promotes the activations to f32, and ``lax.scan`` (qwen) or
    ``lax.cond`` (zamba2's shared block) rejects the changed carry."""
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="bfloat16")
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="must have equal"):
        model.forward(params, {"tokens": jnp.zeros((1, 8), jnp.int32)})


# ---------------------------------------------------------------- layers --
def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x, s, b = normal(rng, 3, 5, 64), normal(rng, 64), normal(rng, 64)
    close(TL.rmsnorm(convert.load_arrays(TL.RMSNorm(64, F32), {"scale": s}), t(x)),
          JL.rmsnorm({"scale": s}, x, 1e-6))
    ln = convert.load_arrays(TL.LayerNorm(64, F32), {"scale": s, "bias": b})
    close(TL.layernorm(ln, t(x + 3.0)), JL.layernorm({"scale": s, "bias": b}, x + 3.0))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    assert np.array_equal(TL.rope_frequencies(32, theta), JL.rope_frequencies(32, theta))
    x = normal(rng, 2, 7, 4, 32)
    pos = (np.arange(7)[None, :] + np.array([[0], [19]])).astype(np.int32)
    close(TL.apply_rope(t(x), t(pos), theta), JL.apply_rope(x, pos, theta))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    jp = JL.mlp_init(jax.random.PRNGKey(0), 64, 96, act, jnp.float32)
    if act == "gelu":  # nonzero biases
        jp = {**jp, "b_up": normal(rng, 96), "b_down": normal(rng, 64)}
    x = normal(rng, 2, 5, 64)
    mod = port(TL.MLP(64, 96, act, F32), jp)
    close(TL.mlp_apply(mod, t(x), act), JL.mlp_apply(jp, x, act))


def test_embed_unembed():
    rng = np.random.default_rng(3)
    table = normal(rng, 50, 16)
    mod = convert.load_arrays(TL.Embedding(50, 16, F32), {"table": table})
    tok = rng.integers(0, 50, (2, 6))
    close(TL.embed(mod, t(tok)), JL.embed({"table": table}, tok))
    x = normal(rng, 2, 6, 16)
    close(TL.unembed(mod, t(x)), JL.unembed({"table": table}, x))


# ------------------------------------------------------------- attention --
def _attn_params(bias, h=4, hkv=2, hd=16, d=64, seed=0):
    jp = JA.attn_init(jax.random.PRNGKey(seed), d, h, hkv, hd, jnp.float32, bias=bias)
    if bias:
        rng = np.random.default_rng(seed)
        jp = {**jp, "bq": normal(rng, h, hd, scale=0.1), "bk": normal(rng, hkv, hd, scale=0.1),
              "bv": normal(rng, hkv, hd, scale=0.1)}
    mod = port(TA.Attention(d, h, hkv, hd, F32, bias=bias), jp)
    return jp, mod


@pytest.mark.parametrize("window,bias", [(0, False), (5, False), (0, True)])
def test_attention_self(window, bias):
    """GQA (4 heads over 2 KV heads), causal, with and without a sliding
    window (gemma3's local layers), with QKV bias (qwen); the rotated K/V
    that ``return_kv`` hands the cache."""
    rng = np.random.default_rng(4)
    jp, mod = _attn_params(bias)
    x = normal(rng, 2, 16, 64)
    jy, (jk, jv) = JA.attention(jp, x, rope_theta=1e4, window=window, return_kv=True)
    ty, (tk, tv) = TA.attention(mod, t(x), rope_theta=1e4, window=window, return_kv=True)
    close(ty, jy)
    close(tk, jk)
    close(tv, jv)
    if window:
        full = TA.attention(mod, t(x), rope_theta=1e4, window=0)
        assert not torch.allclose(full, ty, atol=1e-4)


def test_attention_cross_and_encoder():
    rng = np.random.default_rng(5)
    jp, mod = _attn_params(False)
    x, enc = normal(rng, 2, 6, 64), normal(rng, 2, 11, 64)
    close(TA.attention(mod, t(x), rope_theta=1e4, window=0, causal=False, x_kv=t(enc)),
          JA.attention(jp, x, rope_theta=1e4, window=0, causal=False, x_kv=enc))
    close(TA.attention(mod, t(enc), rope_theta=1e4, window=0, causal=False),
          JA.attention(jp, enc, rope_theta=1e4, window=0, causal=False))
    jk, jv = JA.precompute_cross_kv(jp, enc)
    tk, tv = TA.precompute_cross_kv(mod, t(enc))
    close(tk, jk)
    close(tv, jv)
    q = x[:, :1]
    close(TA.cross_decode_attention(mod, t(q), tk, tv, rope_theta=1e4),
          JA.cross_decode_attention(jp, q, jk, jv, rope_theta=1e4))


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention(window):
    """One token against a cache at a different position in each row: the
    port writes the cache in place, the reference returns a new one."""
    rng = np.random.default_rng(6)
    jp, mod = _attn_params(True)
    x = normal(rng, 2, 1, 64)
    ck, cv = normal(rng, 2, 12, 2, 16), normal(rng, 2, 12, 2, 16)
    pos = np.array([3, 9], np.int32)
    jy, jc = JA.decode_attention(jp, x, JA.KVCache(ck, cv), pos, rope_theta=1e4,
                                 window=window)
    cache = TA.KVCache(t(ck), t(cv))
    ty, tc = TA.decode_attention(mod, t(x), cache, t(pos), rope_theta=1e4, window=window)
    close(ty, jy)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    assert tc.k is cache.k


# ------------------------------------------------------------------- MoE --
def _moe(e=8, k=2, d=32, f=48, dense=False, seed=0):
    jp = JM.moe_init(jax.random.PRNGKey(seed), d, f, e, jnp.float32,
                     dense_residual=dense, f_dense=64)
    mod = port(TM.MoE(d, f, e, F32, dense_residual=dense, f_dense=64), jp)
    return jp, mod


def _jax_expert_idx(jp, x, k):
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jp["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("dense,cf", [(False, 1.25), (True, 1.25), (False, 0.5)])
def test_moe_apply(dense, cf):
    """Outputs, the aux loss and the routing; at capacity factor 0.5 a
    quarter or more of the assignments drop, the same ones."""
    rng = np.random.default_rng(7)
    jp, mod = _moe(dense=dense)
    x = normal(rng, 2, 12, 32)
    jy, jaux = JM.moe_apply(jp, x, k=2, capacity_factor=cf, dense_residual=dense)
    ty, taux = TM.moe_apply(mod, t(x), k=2, capacity_factor=cf, dense_residual=dense)
    close(ty, jy)
    close(taux, jaux)
    _, _, idx = TM.route(mod, t(x).reshape(-1, 32), 2)
    assert np.array_equal(idx.numpy(), _jax_expert_idx(jp, x, 2))


def test_moe_router_tie_breaks_to_lower_index():
    """Two identical router columns give equal probabilities: both
    frameworks put the lower expert first."""
    rng = np.random.default_rng(8)
    jp, _ = _moe()
    router = np.array(jp["router"])
    router[:, 5] = router[:, 2]
    jp = {**jp, "router": router}
    mod = port(TM.MoE(32, 48, 8, F32), jp)
    x = normal(rng, 1, 40, 32)
    _, _, idx = TM.route(mod, t(x).reshape(-1, 32), 2)
    jidx = _jax_expert_idx(jp, x, 2)
    assert np.array_equal(idx.numpy(), jidx)
    tied = (jidx == 2).any(-1) & (jidx == 5).any(-1)
    assert tied.any()
    assert (jidx[tied] == [2, 5]).all()
    close(TM.moe_apply(mod, t(x), k=2)[0], JM.moe_apply(jp, x, k=2)[0])


def test_moe_capacity_overflow_drops_the_same_tokens():
    """A router that puts expert 0 first for every token: 24 tokens at
    capacity ceil(24·2/8·1.25) = 8, so 16 lose their expert-0 share, the
    same ones in both frameworks."""
    rng = np.random.default_rng(9)
    jp, _ = _moe()
    router = np.array(jp["router"])
    router[1, 0] = 50.0
    jp = {**jp, "router": router}
    mod = port(TM.MoE(32, 48, 8, F32), jp)
    x = normal(rng, 2, 12, 32)
    x[..., 1] = 1.0
    assert (_jax_expert_idx(jp, x, 2)[:, 0] == 0).all()
    assert TM.capacity(24, 2, 8, 1.25) == 8
    jy, _ = JM.moe_apply(jp, x, k=2, capacity_factor=1.25)
    ty, _ = TM.moe_apply(mod, t(x), k=2, capacity_factor=1.25)
    close(ty, jy)
    roomy, _ = TM.moe_apply(mod, t(x), k=2, capacity_factor=8.0)  # nothing drops
    close(roomy, JM.moe_apply(jp, x, k=2, capacity_factor=8.0)[0])
    kept = torch.isclose(ty, roomy, atol=ATOL, rtol=RTOL).all(-1).reshape(-1)
    assert 0 < int(kept.sum()) < 24


def test_moe_combine_is_repeatable():
    """The combine's fixed order: the same bits on a rerun."""
    rng = np.random.default_rng(10)
    _, mod = _moe(e=8, k=2)
    x = t(normal(rng, 4, 16, 32))
    a, b = TM.moe_apply(mod, x, k=2)[0], TM.moe_apply(mod, x, k=2)[0]
    assert torch.equal(a, b)


# ------------------------------------------------------------------- SSD --
def _ssd_inputs(rng, b=2, s=20, h=4, p=8, n=6, dt_val=None):
    x = normal(rng, b, s, h, p)
    dt = (np.full((b, s, h), dt_val, np.float32) if dt_val is not None
          else np.abs(normal(rng, b, s, h, scale=0.5)))
    a = -np.array([1.0, 4.0, 16.0, 64.0][:h], np.float32)
    return x, dt, a, normal(rng, b, s, n), normal(rng, b, s, n)


@pytest.mark.parametrize("s,chunk,with_h0", [(16, 8, False), (20, 8, False),
                                             (21, 8, True), (5, 8, False)])
def test_ssd_chunked(s, chunk, with_h0):
    """A multiple of the chunk, a padded tail (dt = 0 padding), an initial
    state, and one short chunk."""
    rng = np.random.default_rng(11)
    x, dt, a, bm, cm = _ssd_inputs(rng, s=s)
    h0 = normal(rng, 2, 4, 6, 8) if with_h0 else None
    jy, jh = JS.ssd_chunked(x, dt, a, bm, cm, chunk, h0)
    ty, th = TS.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), chunk,
                            None if h0 is None else t(h0))
    close(ty, jy)
    close(th, jh)


def test_ssd_chunked_long_decay():
    """|a|·dt·Q up to 2240, the case of test_arch_smoke.py's regression:
    the masked exp stays finite and equal to the reference."""
    rng = np.random.default_rng(12)
    x, dt, a, bm, cm = _ssd_inputs(rng, b=1, s=16, h=4, p=4, n=4, dt_val=5.0)
    jy, jh = JS.ssd_chunked(x, dt, a, bm, cm, 8)
    ty, th = TS.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), 8)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    close(ty, jy)
    close(th, jh)


def test_ssd_step_and_recurrence_equals_chunked():
    rng = np.random.default_rng(13)
    x, dt, a, bm, cm = _ssd_inputs(rng, s=6)
    h = np.zeros((2, 4, 6, 8), np.float32)
    th = torch.zeros(2, 4, 6, 8)
    ys = []
    for i in range(6):
        jy, h = JS.ssd_step(h, x[:, i], dt[:, i], a, bm[:, i], cm[:, i])
        ty, th = TS.ssd_step(th, t(x[:, i]), t(dt[:, i]), t(a), t(bm[:, i]), t(cm[:, i]))
        close(ty, jy)
        ys.append(ty)
    close(th, h)
    cy, ch = TS.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), 4)
    close(torch.stack(ys, 1), cy, atol=1e-4)
    close(ch, th, atol=1e-4)


def _ssm_cfg():
    return jconfigs.get_reduced("mamba2_1_3b")


def test_causal_conv_and_ssm_block():
    rng = np.random.default_rng(14)
    cfg = _ssm_cfg()
    jp = JS.ssm_init(jax.random.PRNGKey(0), cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                     cfg.ssm_state, cfg.ssm_conv_width, jnp.float32)
    mod = port(TS.SSM(cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_conv_width, F32), jp)
    xc = normal(rng, 2, 11, 48)
    w, b = normal(rng, 4, 48), normal(rng, 48)
    close(TS._causal_conv(t(xc), t(w), t(b)), JS._causal_conv(xc, w, b))
    x = normal(rng, 2, 13, cfg.d_model)
    jy, jh = JS.ssm_block(jp, x, cfg)
    ty, th = TS.ssm_block(mod, t(x), tconfigs.get_reduced("mamba2_1_3b"))
    close(ty, jy)
    close(th, jh)


def test_ssm_decode_step():
    rng = np.random.default_rng(15)
    cfg = _ssm_cfg()
    jp = JS.ssm_init(jax.random.PRNGKey(1), cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                     cfg.ssm_state, cfg.ssm_conv_width, jnp.float32)
    mod = port(TS.SSM(cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_conv_width, F32), jp)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    h = normal(rng, 2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    conv = normal(rng, 2, cfg.ssm_conv_width - 1, conv_ch)
    x = normal(rng, 2, 1, cfg.d_model)
    jy, js = JS.ssm_decode_step(jp, x, JS.SSMState(h, conv), cfg)
    ty, ts = TS.ssm_decode_step(mod, t(x), TS.SSMState(t(h), t(conv)),
                                tconfigs.get_reduced("mamba2_1_3b"))
    close(ty, jy)
    close(ts.h, js.h)
    close(ts.conv, js.conv)


# ------------------------------------------------------------ whole model --
@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.model_params_from_arrays(tcfg, tree(jp))
    return jcfg, jm, jp, tm, tp


def batch_for(cfg, bsz, seq, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = normal(rng, bsz, cfg.frontend_seq, cfg.d_model)
    if cfg.family == "audio":
        b["frames"] = normal(rng, bsz, cfg.encoder_seq, cfg.d_model)
    return b


def as_torch(batch):
    out = {k: t(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def router_gaps(run):
    """Calls ``run()`` with every MoE layer's router recorded: per batch
    row, the smallest float64 gap between the k-th and (k+1)-th router
    probability over every layer and position it passed."""
    gaps = []
    orig = TM.moe_apply

    def spy(params, x, *, k, **kw):
        xf = x.reshape(-1, x.shape[-1]).double()
        p = torch.softmax(xf @ params.router.double(), -1)
        v = torch.sort(p, -1, descending=True).values
        gaps.append((v[:, k - 1] - v[:, k]).reshape(x.shape[0], -1).min(-1).values)
        return orig(params, x, k=k, **kw)

    TM.moe_apply = spy
    try:
        with torch.no_grad():
            run()
    finally:
        TM.moe_apply = orig
    return torch.stack(gaps).min(0).values.numpy()


def hold(got, want, cfg, run=None):
    """Within the tolerance; for MoE, any batch row that is not must have
    passed a float64 near-tie of a router (a flipped expert) in ``run``,
    the port's computation of these logits."""
    got = got.detach().numpy()
    want = np.asarray(want)
    ok = np.isclose(got, want, atol=ATOL, rtol=RTOL).reshape(got.shape[0], -1).all(-1)
    if ok.all():
        return
    assert cfg.n_experts, np.abs(got - want).max()
    gaps = router_gaps(run)
    assert (gaps[~ok] < TIE).all(), gaps[~ok]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jm, jp, tm, tp = _models(arch)
    batch = batch_for(cfg, 2, 24, seed=0)  # 24 > gemma3's reduced window of 16
    jl, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, taux = tm.forward(tp, as_torch(batch))
    assert tl.shape == jl.shape
    hold(tl, jl, cfg, lambda: tm.forward(tp, as_torch(batch)))
    close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, jm, jp, tm, tp = _models(arch)
    batch = batch_for(cfg, 2, 20, seed=1)
    extra = cfg.frontend_seq if cfg.family == "vlm" else 0
    s_max = 20 + extra + 4
    jl, js = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, s_max=s_max)
    with torch.no_grad():
        tl, ts = tm.prefill(tp, as_torch(batch), s_max)
    assert tl.dtype == F32 and tl.shape == jl.shape
    hold(tl, jl, cfg, lambda: tm.forward(tp, as_torch(batch)))
    assert ts.length == 20 + extra and np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    for name in ("kv_k", "kv_v", "ssm_h", "ssm_conv", "shared_k", "shared_v",
                 "cross_k", "cross_v"):
        jv, tv = getattr(js, name), getattr(ts, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Prefill 14 tokens, then 3 teacher-forced decode steps; the caches
    then hold s_max positions, and a fourth step raises (an SSM has no
    cache bound)."""
    cfg, jm, jp, tm, tp = _models(arch)
    batch = batch_for(cfg, 2, 17, seed=2)
    tokens = batch["tokens"]
    extra = cfg.frontend_seq if cfg.family == "vlm" else 0
    prompt = {**batch, "tokens": tokens[:, :14]}
    s_max = 17 + extra

    def replay(upto):
        _, s = tm.prefill(tp, as_torch(prompt), s_max)
        for j in range(14, upto + 1):
            _, s = tm.decode_step(tp, t(tokens[:, j]).long(), s)

    _, js = jm.prefill(jp, {k: jnp.asarray(v) for k, v in prompt.items()}, s_max=s_max)
    with torch.no_grad():
        _, ts = tm.prefill(tp, as_torch(prompt), s_max)
        for i in range(14, 17):
            jl, js = jm.decode_step(jp, jnp.asarray(tokens[:, i]), js)
            tl, ts = tm.decode_step(tp, t(tokens[:, i]).long(), ts)
            assert tl.dtype == F32 and tl.shape == jl.shape
            hold(tl, jl, cfg, functools.partial(replay, i))
        assert ts.length == s_max
        if cfg.family == "ssm":
            tm.decode_step(tp, t(tokens[:, 0]).long(), ts)
        else:
            with pytest.raises(ValueError, match="full"):
                tm.decode_step(tp, t(tokens[:, 0]).long(), ts)


# ------------------------------------------------------------- parameters --
def _unstacked_shapes(jtree):
    out = {}
    for name, leaf in convert.flatten(jtree).items():
        top = name.split(".")[0]
        if top in convert.STACKED:
            rest = name[len(top) + 1:]
            for i in range(leaf.shape[0]):
                out[f"{top}.{i}.{rest}"] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_published_widths(arch):
    """The meta-device shapes of the published config (activations in
    float32, as ``--full-size`` runs it) against ``jax.eval_shape`` of the
    reference's init, leaf for leaf after unstacking the layer axis."""
    jcfg = jconfigs.get_config(arch)
    tcfg = dataclasses.replace(tconfigs.get_config(arch), dtype="float32")
    want = _unstacked_shapes(jbuild(jcfg).param_shapes())
    got = {n: (s, str(d).replace("torch.", "")) for n, (s, d) in
           tbuild(tcfg).param_shapes().items()}
    assert got == want
    assert sum(np.prod(s) for s, _ in got.values()) > 0


STDS = {"table": 0.01, "router": 0.01, "conv_w": 0.1}


def test_inits_match_reference():
    """Deterministic leaves: equal to the reference's bits (a_log within 4
    ulp: XLA folds ``jnp.linspace``'s division into a reciprocal product
    and computes its own ``log``); random leaves: each name's std, over
    all its layers, within 5% of the stated one."""
    for arch in ("zamba2_2_7b", "whisper_medium", "arctic_480b", "qwen1_5_0_5b"):
        cfg, _, jp, tm, _ = _models(arch)
        want = convert.unstack_layers(tree(jp))
        params = tm.init(0, device="cpu")
        got = {n: p.detach().numpy() for n, p in params.named_parameters()}
        assert got.keys() == want.keys()
        groups = {}
        for name, arr in got.items():
            leaf = name.split(".")[-1]
            if leaf == "a_log":
                np.testing.assert_allclose(arr, want[name], rtol=5e-7, atol=0)
            elif leaf in ("scale", "bias", "b_up", "b_down", "bq", "bk", "bv",
                          "conv_b", "dt_bias", "d_skip"):
                assert np.array_equal(arr, want[name]), name
            else:
                groups.setdefault(leaf, []).append(arr.ravel())
        for leaf, parts in groups.items():
            vals = np.concatenate(parts)
            assert vals.size >= 4096, (arch, leaf)
            std = STDS.get(leaf, 0.02)
            assert abs(vals.std() / std - 1) < 0.05, (arch, leaf, vals.std())
            assert abs(vals.mean()) < 0.1 * std, (arch, leaf)


def test_model_params_from_arrays_rejects_mismatch():
    _, _, jp, tm, _ = _models("qwen1_5_0_5b")
    cfg, tr = tm.cfg, tree(jp)
    bad = {**tr, "final_norm": {"scale": np.ones(3, np.float32)}}
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.model_params_from_arrays(cfg, bad)
    with pytest.raises(KeyError, match="unembed"):
        convert.model_params_from_arrays(cfg, {**tr, "unembed": {"table": tr["embed"]["table"]}})
