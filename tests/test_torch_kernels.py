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
from repro_torch.kernels import _build, cutbatch, fused_layer, mixer, ops, phase, ref
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
    b = beta.clone().requires_grad_(True)  # the layer backward: ∂β's plain branch
    torch.autograd.grad(ops.apply_layer(re, im, cutv, gamma, b, n, group=k)[0].sum(), b)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_wrappers_reject_other_devices():
    meta = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        phase.expectation(meta, meta, meta)


# ---------------------------------------------------------------------------
# the tuning slice: apply_phase, cut_batch_dense, the relayout path, and the
# graph helpers that feed them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [6, 9, 10])
def test_apply_phase_plain_matches_pallas_and_jax_ref(n):
    """Per-row γ against the Pallas kernel row by row and the JAX ref:
    an elementwise rotation of O(1) amplitudes, so atol 1e-6."""
    from repro.kernels import phase as jax_phase_k

    re, im, cutv, gamma, _ = _state(n, seed=400 + n)
    got = phase.apply_phase(_t(re), _t(im), _t(cutv), _t(gamma))
    via_ops = ops.apply_phase(_t(re), _t(im), _t(cutv), _t(gamma))
    for g, o in zip(got, via_ops):
        assert torch.equal(g, o)
    for r in range(B):
        args = (jnp.asarray(re[r]), jnp.asarray(im[r]), jnp.asarray(cutv[r]),
                jnp.float32(gamma[r]))
        for want in (jax_phase_k.apply_phase(*args, interpret=True), _jphase(*args)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=1e-6)


def _spins(b, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (b, v)) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("v,b", [(48, 37), (50, 64)])
def test_cut_batch_dense_plain_equals_pallas_on_unweighted_graphs(v, b):
    """V and B divide no tile; ±1 spins and unit weights sum to integers
    below 2^24, so the plain version, the Pallas kernel, the JAX ref and
    the edge-list cut agree exactly."""
    from repro.core.graph import Graph as JGraph, cut_value_batch as jcut_batch
    from repro.kernels import cutbatch as jax_cutbatch
    from repro_torch.core import graph as tgraph

    s = _spins(b, v, seed=v)
    jg = JGraph.erdos_renyi(v, 0.3, seed=v)
    tg = tgraph.Graph.erdos_renyi(v, 0.3, seed=v)
    adj = tg.dense_adjacency()
    wtot = tg.total_weight()
    got = ops.cut_batch_dense(_t(s), adj, wtot).numpy()
    jadj = jg.dense_adjacency()
    jw = jg.total_weight()
    np.testing.assert_array_equal(got, np.asarray(jax_cutbatch.cut_batch_dense(
        jnp.asarray(s), jadj, jw, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_ref.cut_batch_dense(
        jnp.asarray(s), jadj, jw)))
    x = ((s + 1) / 2).astype(np.int32)
    np.testing.assert_array_equal(got, tgraph.cut_value_batch(tg, _t(x)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jcut_batch(jg, jnp.asarray(x))))


def test_cut_batch_dense_plain_on_weighted_graph_within_tolerance():
    """Real weights: the sums round, so within 1e-5 · Σ|w|."""
    from repro.core.graph import Graph as JGraph
    from repro.kernels import cutbatch as jax_cutbatch
    from repro_torch.core import graph as tgraph

    v, b = 50, 40
    s = _spins(b, v, seed=11)
    tg = tgraph.Graph.erdos_renyi_weighted(v, 0.3, seed=4)
    jg = JGraph.erdos_renyi_weighted(v, 0.3, seed=4)
    got = cutbatch.cut_batch_dense(_t(s), tg.dense_adjacency(), float(tg.total_weight()))
    want = jax_cutbatch.cut_batch_dense(jnp.asarray(s), jg.dense_adjacency(),
                                        float(jg.total_weight()), interpret=True)
    scale = float(tg.weights.abs().sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    exact = tgraph.cut_value_batch(tg, _t(((s + 1) / 2).astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_adjacency_and_cut_value_batch_match_jax(weighted):
    from repro.core import graph as jgraph
    from repro_torch.core import graph as tgraph

    make = "erdos_renyi_weighted" if weighted else "erdos_renyi"
    jg = getattr(jgraph.Graph, make)(30, 0.25, seed=5, pad_to=120)
    tg = getattr(tgraph.Graph, make)(30, 0.25, seed=5, pad_to=120)
    np.testing.assert_array_equal(tg.dense_adjacency().numpy(),
                                  np.asarray(jg.dense_adjacency()))
    x = np.random.default_rng(6).integers(0, 2, (9, 30)).astype(np.int32)
    # unit weights sum exactly; real ones round in each framework's order
    atol = 1e-5 * float(tg.weights.abs().sum()) if weighted else 0.0
    np.testing.assert_allclose(tgraph.cut_value_batch(tg, _t(x)).numpy(),
                               np.asarray(jgraph.cut_value_batch(jg, jnp.asarray(x))),
                               rtol=0, atol=atol)
    jp = jgraph.Problem.mis(jgraph.Graph.erdos_renyi(30, 0.25, seed=5))
    tp = tgraph.Problem.mis(tgraph.Graph.erdos_renyi(30, 0.25, seed=5))
    np.testing.assert_allclose(
        tgraph.problem_value_batch(tp, _t(x)).numpy(),
        np.asarray(jgraph.problem_value_batch(jp, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("n,lo,k", [(9, 2, 7), (10, 5, 3), (6, 0, 3)])
def test_mixer_relayout_plain_matches_pallas_relayout(n, lo, k):
    re, im, _, _, beta = _state(n, seed=500 + n + lo)
    got = mixer.apply_mixer_bits_relayout(_t(re), _t(im), n, lo, k, _t(beta))
    strided = mixer.apply_mixer_bits(_t(re), _t(im), n, lo, k, _t(beta))
    for r in range(B):
        want = jax_mixer.apply_mixer_bits_relayout(
            jnp.asarray(re[r]), jnp.asarray(im[r]), n, lo, k,
            jnp.float32(beta[r]), interpret=True)
        for g, s, w in zip(got, strided, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=STATE_ATOL)
            np.testing.assert_allclose(g[r].numpy(), s[r].numpy(), atol=STATE_ATOL)


def test_new_ops_on_cpu_launch_nothing(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    ops.reset_launch_counts()
    re, im, cutv, gamma, _ = (_t(a) for a in _state(6, seed=8))
    ops.apply_phase(re, im, cutv, gamma)
    ops.cut_batch_dense(_t(_spins(4, 10, 1)), torch.ones((10, 10)), 5.0)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert {"apply_phase", "cut_batch_dense"} <= set(ops.KERNELS)
