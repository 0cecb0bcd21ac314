"""The layer backward's gradients at the mixer's input, on the CPU.

On the card the reversed fused pass computes ∂γ and the ∂β of the qubits
it holds, [0, f), from w = U_M^† d (the output's cotangent with every
qubit's RX undone) and v = e^{-iγc}·in (the state before the mixer);
`betagrad` keeps the ∂β of the strided qubits [f, n) on the layer output.
These tests hold the algebra and the plain mirror `ref.layer_grads_split`
that the CUDA tests hold the kernel to:

- in float64, Im⟨d|X_q|o⟩ at the output equals Im⟨w|X_q|v⟩ at the
  mixer's input for each q < f (X_q commutes with every RX factor);
- the mirror's ∂γ and ∂β, with ∂β of [f, n) from the output, equal
  `ref.phase_grad` and `ref.beta_grad(…, 0, n)` within their tolerances;
- the ∂β reads left to `betagrad`, `ref.beta_grad_launches(f, n − f)`,
  are fewer than over all n qubits.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import betagrad, ops, ref

B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer(n, seed, dtype):
    """A layer's input, cost values, angles and output cotangent; its
    output o and the mixer's input v, w = U_M^† d, in ``dtype``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    re, im, d_re, d_im = (rng.standard_normal((B, 2**n)) for _ in range(4))
    norm = np.sqrt((re**2 + im**2).sum(1, keepdims=True))
    re, im, d_re, d_im = t(re / norm), t(im / norm), t(d_re / norm), t(d_im / norm)
    cutv = t(rng.integers(0, n, (B, 2**n)))
    gamma, beta = t(rng.uniform(-1.5, 1.5, B)), t(rng.uniform(-1.5, 1.5, B))
    v = ref.apply_phase(re, im, cutv, gamma)
    o = ref.apply_mixer(*v, n, beta, group=4)
    w = ref.apply_mixer(d_re, d_im, n, -beta, group=4)
    return dict(re=re, im=im, d=(d_re, d_im), cutv=cutv, gamma=gamma, v=v, o=o, w=w)


@pytest.mark.parametrize("n", [6, 9, 13])
def test_beta_term_of_each_fused_qubit_is_the_same_at_the_mixer_input(n):
    """Im⟨d|X_q|o⟩ = Im⟨U_M^† d|X_q|v⟩ for every q the fused pass holds,
    in float64 (`ref.beta_grad` over the one qubit q)."""
    x = _layer(n, 10 + n, torch.float64)
    f = ops.layer_passes(n, 7)[0]
    for q in range(f):
        at_out = ref.beta_grad(*x["d"], *x["o"], q, 1)
        at_in = ref.beta_grad(*x["w"], *x["v"], q, 1)
        torch.testing.assert_close(at_in, at_out, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n,f", [(8, 8), (12, 12), (13, 7), (14, 7), (20, 7)])
def test_layer_grads_split_matches_the_plain_gradients(n, f):
    """The mirror's ∂γ against `ref.phase_grad` on the pulled-back
    cotangent, within 1e-5 of Σ|c|·(|im·ḡre| + |re·ḡim|) a row; its ∂β over
    [0, f) plus `ref.beta_grad` over [f, n) on the output against
    `ref.beta_grad` over all n qubits, within `betagrad.tolerance`."""
    assert ops.layer_passes(n, 7)[0] == f
    x = _layer(n, 30 + n, torch.float32)
    re, im, cutv, gamma = x["re"], x["im"], x["cutv"], x["gamma"]
    d_gamma, d_beta = ref.layer_grads_split(*x["w"], re, im, cutv, gamma, f)
    g_re, g_im = ref.apply_phase(*x["w"], cutv, -gamma)
    want = ref.phase_grad(re, im, g_re, g_im, cutv)
    scale = (cutv.abs() * ((im * g_re).abs() + (re * g_im).abs())).sum(-1)
    assert bool(((d_gamma - want).abs() <= 1e-5 * scale).all()), (d_gamma, want)
    if f < n:
        d_beta = d_beta + ref.beta_grad(*x["d"], *x["o"], f, n - f)
    want = ref.beta_grad(*x["d"], *x["o"], 0, n)
    tol = betagrad.tolerance(*x["d"], *x["o"], 0, n)
    assert bool(((d_beta - want).abs() <= tol).all()), (d_beta, want, tol)


def test_layer_grads_split_sums_each_amplitudes_tree_as_beta_grad_split():
    """Each amplitude's ∂β terms fill leaves 0..f−1 of ∂β's pairwise
    tree, as `ref.beta_grad_split` fills a group of f qubits on
    contiguous tiles: the two agree to the f64 order of their sums."""
    n = 10
    x = _layer(n, 7, torch.float32)
    _, got = ref.layer_grads_split(*x["w"], x["re"], x["im"], x["cutv"], x["gamma"], n)
    want = ref.beta_grad_split(*x["w"], *x["v"], 0, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_strided_beta_reads_are_fewer_than_over_all_qubits():
    """The reads `betagrad` keeps, over the strided qubits [f, n), against
    today's over [0, n): none for n ≤ 12, fewer for every n from 13 to 26
    but 20 (two either way), and at n = 26 exactly the second read over
    all 26 qubits (qubits 12–18 with 19–25 on 32 lanes)."""
    for n in range(1, 27):
        f, groups = ops.layer_passes(n, 7)
        whole = ref.beta_grad_launches(0, n)
        if n <= 12:
            assert (f, groups) == (n, ())
            continue
        left = ref.beta_grad_launches(f, n - f)
        if n == 20:
            assert len(left) == len(whole) == 2
        else:
            assert len(left) < len(whole), n
    assert ref.beta_grad_launches(12, 14) == [ref.beta_grad_launches(0, 26)[1]]
    assert ref.beta_grad_launches(10, 14) == [
        (ref.BetaPass(10, 7, 32), ref.BetaPass(17, 7, 32))]
