"""The port's plain kernel versions against the JAX package's Pallas kernels.

Each case builds its inputs with numpy from a seed and feeds the same
arrays to both packages: the Pallas kernel runs in interpret mode (as the
JAX package's own tests run it on the CPU), once per batch row with that
row's angles, and the port's wrapper runs the whole batch on CPU tensors,
which takes the plain branch. The CUDA kernels themselves are held against
these plain versions on the GPU by ``chip_smoke.py`` and by the
``cuda``-marked tests in tests/test_torch_cuda.py.

Tolerances: states ``atol 2e-5`` (as tests/test_fused_layer_kernel.py:
f32 rounding of a 2^k-term product over O(1) amplitudes); ⟨cut⟩ ``rtol
1e-5`` (f32 sums of 2^n terms in another order); cut values with integer
weights exactly (0/1 times an integer is exact in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cutvals as jax_cutvals
from repro.kernels import fused_layer as jax_fused
from repro.kernels import mixer as jax_mixer
from repro.kernels import phase as jax_phase
from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build, fused_layer, mixer, ops, phase, ref
from repro_torch.kernels import cutvals as cutvals_mod

STATE_ATOL = 2e-5
EXP_RTOL = 1e-5
B = 3  # batch rows per case, each with its own angles


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny tensors: intra-op threads only add scheduling overhead here
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(n, seed, b=B):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((b, 2**n)).astype(np.float32)
    im = rng.standard_normal((b, 2**n)).astype(np.float32)
    norm = np.sqrt((re**2 + im**2).sum(1, keepdims=True))
    cutv = (rng.uniform(0, n, (b, 2**n))).astype(np.float32)
    gamma = rng.uniform(-2, 2, b).astype(np.float32)
    beta = rng.uniform(-2, 2, b).astype(np.float32)
    return re / norm, im / norm, cutv, gamma, beta


def _edges(n, seed, b=B, e=12):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (b, e, 2)).astype(np.int32)
    edges[:, -2:] = 0  # padding rows (0, 0, w=0)
    w = rng.choice(np.asarray([-1.0, 1.0, 2.0], np.float32), (b, e))
    w[:, -2:] = 0.0
    lin = rng.standard_normal((b, n)).astype(np.float32)
    return edges, w.astype(np.float32), lin


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# the JAX references, compiled once per shape (eager dispatch is slow)
_jcutvals = jax.jit(jax_ref.cutvals, static_argnums=0)
_jphase = jax.jit(jax_ref.apply_phase)
_jmixer = jax.jit(jax_ref.apply_mixer, static_argnums=(2, 4))
_jexp = jax.jit(jax_ref.expectation)
_jrx = jax.jit(jax_ref.rx_kron_parts, static_argnums=1)
_jgroup = jax.jit(jax_mixer.rx_group_mats, static_argnums=1)


@pytest.mark.parametrize("n", [6, 9, 10])
def test_cutvals_plain_matches_pallas(n):
    edges, w, lin = _edges(n, seed=n)
    got = cutvals_mod.cutvals(n, _t(edges), _t(w)).numpy()
    got_lin = cutvals_mod.cutvals(n, _t(edges), _t(w), _t(lin)).numpy()
    for r in range(B):
        want = jax_cutvals.cutvals(n, jnp.asarray(edges[r]), jnp.asarray(w[r]),
                                   interpret=True)
        np.testing.assert_array_equal(got[r], np.asarray(want))
        want_lin = jax_cutvals.cutvals(n, jnp.asarray(edges[r]),
                                       jnp.asarray(w[r]), jnp.asarray(lin[r]),
                                       interpret=True)
        np.testing.assert_allclose(got_lin[r], np.asarray(want_lin), atol=1e-5)


@pytest.mark.parametrize("n,s", [(6, 2), (9, 4)])
def test_cutvals_at_plain_matches_pallas(n, s):
    """An (S, L) table of arbitrary states, shared by every edge row."""
    edges, w, lin = _edges(n, seed=50 + n)
    idx = np.random.default_rng(n).permutation(2**n)[: s * 2**(n - 2)]
    idx = idx.reshape(s, -1).astype(np.int32)
    got = cutvals_mod.cutvals_at(_t(idx), _t(edges), _t(w)).numpy()
    got_lin = cutvals_mod.cutvals_at(_t(idx), _t(edges), _t(w), _t(lin)).numpy()
    for r in range(B):
        for q in range(s):
            args = (jnp.asarray(idx[q]), jnp.asarray(edges[r]), jnp.asarray(w[r]))
            want = jax_cutvals.cutvals_at(*args, interpret=True)
            np.testing.assert_array_equal(got[r * s + q], np.asarray(want))
            want_lin = jax_cutvals.cutvals_at(*args, jnp.asarray(lin[r]),
                                              interpret=True)
            np.testing.assert_allclose(got_lin[r * s + q], np.asarray(want_lin),
                                       atol=1e-5)


@pytest.mark.parametrize("n,k", [(6, 3), (9, 7), (4, 2)])
def test_trailing_mixer_plain_matches_pallas_matmul(n, k):
    re, im, _, _, beta = _state(n, seed=60 + n + k)
    v = (B, -1, 2**k)
    got = mixer.mixer_group_trailing(_t(re).view(v), _t(im).view(v), _t(beta), k)
    for r in range(B):
        want = jax_mixer.mixer_group_matmul(
            jnp.asarray(re[r]).reshape(-1, 2**k), jnp.asarray(im[r]).reshape(-1, 2**k),
            jnp.float32(beta[r]), k, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=STATE_ATOL)


@pytest.mark.parametrize("n,k", [(6, 3), (9, 7), (10, 5)])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_plain_matches_pallas(n, k, reverse):
    re, im, cutv, gamma, beta = _state(n, seed=10 * n + k)
    v = (B, -1, 2**k)
    got = fused_layer.fused_phase_mixer_group(
        _t(re).view(v), _t(im).view(v), _t(cutv).view(v), _t(gamma), _t(beta),
        k, reverse=reverse)
    for r in range(B):
        want = jax_fused.fused_phase_mixer_group(
            jnp.asarray(re[r]).reshape(-1, 2**k), jnp.asarray(im[r]).reshape(-1, 2**k),
            jnp.asarray(cutv[r]).reshape(-1, 2**k), jnp.float32(gamma[r]),
            jnp.float32(beta[r]), k, reverse=reverse, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=STATE_ATOL)


@pytest.mark.parametrize("n,lo,k", [
    (6, 0, 3),  # trailing group: the JAX package's matmul kernel
    (10, 0, 7),
    (6, 3, 3),  # strided: X > 1 and Y > 1
    (9, 2, 7),
    (10, 5, 5),  # strided, X == 1
])
def test_mixer_bits_plain_matches_pallas(n, lo, k):
    re, im, _, _, beta = _state(n, seed=100 + n + lo)
    got = mixer.apply_mixer_bits(_t(re), _t(im), n, lo, k, _t(beta))
    for r in range(B):
        want = jax_mixer.apply_mixer_bits(jnp.asarray(re[r]), jnp.asarray(im[r]),
                                          n, lo, k, jnp.float32(beta[r]),
                                          interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=STATE_ATOL)


@pytest.mark.parametrize("n", [6, 9, 10])
def test_expectation_plain_matches_pallas(n):
    re, im, cutv, _, _ = _state(n, seed=200 + n)
    got = phase.expectation(_t(re), _t(im), _t(cutv)).numpy()
    for r in range(B):
        want = jax_phase.expectation(jnp.asarray(re[r]), jnp.asarray(im[r]),
                                     jnp.asarray(cutv[r]), interpret=True)
        np.testing.assert_allclose(got[r], float(want), rtol=EXP_RTOL)


# ---------------------------------------------------------------------------
# the port's ref against the JAX package's ref
# ---------------------------------------------------------------------------

def test_popcount_and_linear_rows_match_jax_ref():
    x = np.arange(0, 1 << 12, 7, dtype=np.int32)
    np.testing.assert_array_equal(ref.popcount(_t(x)).numpy(),
                                  np.asarray(jax_ref.popcount(jnp.asarray(x))))
    edges, w, lin = _edges(6, seed=3)
    e2, w2 = ref.append_linear_rows(_t(edges), _t(w), _t(lin))
    for r in range(B):
        je, jw = jax_ref.append_linear_rows(jnp.asarray(edges[r]),
                                            jnp.asarray(w[r]), jnp.asarray(lin[r]))
        np.testing.assert_array_equal(e2[r].numpy(), np.asarray(je))
        np.testing.assert_array_equal(w2[r].numpy(), np.asarray(jw))


@pytest.mark.parametrize("n", [6, 9])
def test_state_ops_match_jax_ref(n):
    re, im, cutv, gamma, beta = _state(n, seed=300 + n)
    edges, w, lin = _edges(n, seed=n)
    cv = ref.cutvals(n, _t(edges), _t(w), _t(lin)).numpy()
    ph = ref.apply_phase(_t(re), _t(im), _t(cutv), _t(gamma))
    mx = ref.apply_mixer(_t(re), _t(im), n, _t(beta), group=4)
    ex = ref.expectation(_t(re), _t(im), _t(cutv)).numpy()
    for r in range(B):
        np.testing.assert_allclose(
            cv[r], np.asarray(_jcutvals(n, jnp.asarray(edges[r]),
                                        jnp.asarray(w[r]), jnp.asarray(lin[r]))),
            atol=1e-5)
        want = _jphase(jnp.asarray(re[r]), jnp.asarray(im[r]),
                       jnp.asarray(cutv[r]), jnp.float32(gamma[r]))
        for g, wt in zip(ph, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(wt), atol=STATE_ATOL)
        want = _jmixer(jnp.asarray(re[r]), jnp.asarray(im[r]), n,
                       jnp.float32(beta[r]), 4)
        for g, wt in zip(mx, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(wt), atol=STATE_ATOL)
        np.testing.assert_allclose(
            ex[r], float(_jexp(jnp.asarray(re[r]), jnp.asarray(im[r]),
                               jnp.asarray(cutv[r]))), rtol=EXP_RTOL)


# angles whose cos or sin is negative exercise the sign-exact integer powers
BETAS = np.asarray([0.3, -0.7, 2.5, -2.9, 1.9], np.float32)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_rx_parts_and_group_mats_match_jax(k):
    C, D = ref.rx_kron_parts(_t(BETAS), k)
    Cg, Dg = mixer.rx_group_mats(_t(BETAS), k)
    for r, b in enumerate(BETAS):
        jc, jd = _jrx(jnp.float32(b), k)
        np.testing.assert_allclose(C[r].numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(D[r].numpy(), np.asarray(jd), atol=1e-6)
        gc, gd = _jgroup(jnp.float32(b), k)
        np.testing.assert_allclose(Cg[r].numpy(), np.asarray(gc), atol=1e-6)
        np.testing.assert_allclose(Dg[r].numpy(), np.asarray(gd), atol=1e-6)
    # the generator form and the cumulative-product form are one unitary
    np.testing.assert_allclose(Cg.numpy(), C.numpy(), atol=1e-6)
    np.testing.assert_allclose(Dg.numpy(), D.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain branch and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_branch_and_count_no_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    ops.reset_launch_counts()
    n, k = 9, 7
    re, im, cutv, gamma, beta = (_t(a) for a in _state(n, seed=5))
    edges, w, lin = (_t(a) for a in _edges(n, seed=5))
    ops.cutvals(n, edges, w, lin)
    ops.cutvals_at(torch.arange(16, dtype=torch.int32).view(2, 8), edges, w, lin)
    ops.apply_layer(re, im, cutv, gamma, beta, n, group=k)
    ops.apply_mixer_bits(re, im, n, 2, 7, beta)
    ops.apply_mixer(re, im, n, beta, group=k)
    ops.expectation(re, im, cutv)
    v = (B, -1, 2**k)
    fused_layer.fused_phase_mixer_group(re.view(v), im.view(v), cutv.view(v),
                                        gamma, beta, k, reverse=True)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_wrappers_reject_other_devices():
    meta = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        phase.expectation(meta, meta, meta)
