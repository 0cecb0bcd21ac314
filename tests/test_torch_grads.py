"""The port's autograd rules against ``jax.grad`` through the JAX ops.

Each case makes a batch of states, cut values, per-row angles and a random
linear functional of the outputs with numpy, and takes the gradient of
``Σ w_re·ore + w_im·oim`` (the oracle form of tests/test_kernel_grads.py)
two ways: ``jax.grad`` through ``repro.kernels.ops`` under the ``xla``
implementation, one row at a time, and ``torch.autograd`` through the
port's batched ``autograd.Function``s on CPU tensors. Rows are independent,
so the port's gradient of the summed loss is each row's own gradient.

Tolerance ``rtol 1e-4, atol 1e-5`` (as tests/test_kernel_grads.py): the
backward passes re-run the layer at negated angles, so f32 rounding from
several 2^k-term products and 2^n-term reductions accumulates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.kernels import betagrad, ops, ref

RTOL, ATOL = 1e-4, 1e-5
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((B, 2**n))
    im = rng.standard_normal((B, 2**n))
    norm = np.sqrt((re**2 + im**2).sum(1, keepdims=True))
    f = np.float32
    return {
        "re": (re / norm).astype(f), "im": (im / norm).astype(f),
        "cutv": rng.uniform(0, n, (B, 2**n)).astype(f),
        "gamma": rng.uniform(-1.5, 1.5, B).astype(f),
        "beta": rng.uniform(-1.5, 1.5, B).astype(f),
        "w_re": rng.standard_normal((B, 2**n)).astype(f),
        "w_im": rng.standard_normal((B, 2**n)).astype(f),
    }


def _torch_grads(fn, x, names):
    leaves = {k: torch.from_numpy(v).requires_grad_(k in names)
              for k, v in x.items()}
    out = fn(leaves)
    if isinstance(out, tuple):
        loss = (leaves["w_re"] * out[0] + leaves["w_im"] * out[1]).sum()
    else:
        loss = out.sum()
    return [g.numpy() for g in torch.autograd.grad(loss, [leaves[k] for k in names])]


def _jax_grad_fn(fn, names):
    """One jitted ``jax.grad`` per case: compiled on the first row under
    the ``xla`` implementation, reused for the others."""

    def loss(vals, rest):
        a = dict(rest, **dict(zip(names, vals)))
        out = fn(a)
        if isinstance(out, tuple):
            return jnp.sum(a["w_re"] * out[0]) + jnp.sum(a["w_im"] * out[1])
        return out

    return jax.jit(jax.grad(loss))


def _jax_grads(grad_fn, x, names, row):
    args = {k: jnp.asarray(v[row]) for k, v in x.items()}
    rest = {k: v for k, v in args.items() if k not in names}
    with jax_ops.using_implementation("xla"):
        grads = grad_fn([args[k] for k in names], rest)
    return [np.asarray(g) for g in grads]


def _check(torch_fn, jax_fn, x, names):
    got = _torch_grads(torch_fn, x, names)
    grad_fn = _jax_grad_fn(jax_fn, names)
    for row in range(B):
        want = _jax_grads(grad_fn, x, names, row)
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g[row], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"d_{name}, row {row}")


@pytest.mark.parametrize("n,group", [(4, 7), (6, 3), (6, 7), (9, 4)])
def test_apply_layer_grads_match_jax(n, group):
    names = ["re", "im", "cutv", "gamma", "beta"]
    _check(
        lambda a: ops.apply_layer(a["re"], a["im"], a["cutv"], a["gamma"],
                                  a["beta"], n, group),
        lambda a: jax_ops.apply_layer(a["re"], a["im"], a["cutv"], a["gamma"],
                                      a["beta"], n, group=group),
        _inputs(n, seed=n + group), names)


@pytest.mark.parametrize("n,lo,k", [(5, 0, 3), (7, 2, 3), (8, 5, 3), (9, 2, 7)])
def test_apply_mixer_bits_grads_match_jax(n, lo, k):
    names = ["re", "im", "beta"]
    _check(
        lambda a: ops.apply_mixer_bits(a["re"], a["im"], n, lo, k, a["beta"]),
        lambda a: jax_ops.apply_mixer_bits(a["re"], a["im"], n, lo, k, a["beta"]),
        _inputs(n, seed=10 + n + lo), names)


@pytest.mark.parametrize("n,group", [(5, 7), (9, 4)])
def test_apply_mixer_grads_match_jax(n, group):
    """The full mixer: the trailing group, then the strided ones."""
    names = ["re", "im", "beta"]
    _check(
        lambda a: ops.apply_mixer(a["re"], a["im"], n, a["beta"], group),
        lambda a: jax_ops.apply_mixer(a["re"], a["im"], n, a["beta"], group=group),
        _inputs(n, seed=30 + n), names)


@pytest.mark.parametrize("n", [4, 8])
def test_expectation_grads_match_jax(n):
    names = ["re", "im", "cutv"]
    _check(
        lambda a: ops.expectation(a["re"], a["im"], a["cutv"]),
        lambda a: jax_ops.expectation(a["re"], a["im"], a["cutv"]),
        _inputs(n, seed=20 + n), names)


def test_qaoa_expectation_grads_match_jax_end_to_end():
    """∂⟨cut⟩/∂(γ, β) through p = 3 layers, per-row angles."""
    from repro.core import qaoa as jax_qaoa

    n, p = 6, 3
    x = _inputs(n, seed=7)
    rng = np.random.default_rng(8)
    gammas = rng.uniform(0.1, 0.8, (B, p)).astype(np.float32)
    betas = rng.uniform(0.1, 0.8, (B, p)).astype(np.float32)
    g = torch.from_numpy(gammas).requires_grad_(True)
    b = torch.from_numpy(betas).requires_grad_(True)
    out = qaoa_mod.qaoa_expectation((g, b), torch.from_numpy(x["cutv"]), n)
    got = torch.autograd.grad(out.sum(), (g, b))
    grad_fn = jax.jit(jax.grad(jax_qaoa.qaoa_expectation), static_argnums=2)
    with jax_ops.using_implementation("xla"):
        for row in range(B):
            want = grad_fn((jnp.asarray(gammas[row]), jnp.asarray(betas[row])),
                           jnp.asarray(x["cutv"][row]), n)
            for gt, w in zip(got, want):
                np.testing.assert_allclose(gt[row].numpy(), np.asarray(w),
                                           rtol=RTOL, atol=5e-5)


def test_layer_backward_leaves_cutv_gradient_out_when_not_needed():
    """The solve never differentiates the cut values: the layer backward
    returns no ∂cutv then, and the state/angle gradients are unchanged."""
    n = 5
    x = _inputs(n, seed=9)
    with_cutv = _torch_grads(
        lambda a: ops.apply_layer(a["re"], a["im"], a["cutv"], a["gamma"],
                                  a["beta"], n, 7),
        x, ["re", "im", "cutv", "gamma", "beta"])
    without = _torch_grads(
        lambda a: ops.apply_layer(a["re"], a["im"], a["cutv"], a["gamma"],
                                  a["beta"], n, 7),
        x, ["re", "im", "gamma", "beta"])
    for a, b in zip([with_cutv[i] for i in (0, 1, 3, 4)], without):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [4, 8])
def test_apply_phase_grads_match_jax(n):
    """The phase rule (the same rotation at −γ on the cotangent, then
    d_γ = Σ cutv·t, d_cutv = γ·t) against ``jax.grad`` through the JAX
    ``custom_vjp``: one rotation and one 2^n-term sum, so rtol 1e-5 (atol
    1e-6 for entries that cancel to near zero)."""
    names = ["re", "im", "cutv", "gamma"]
    x = _inputs(n, seed=40 + n)
    got = _torch_grads(
        lambda a: ops.apply_phase(a["re"], a["im"], a["cutv"], a["gamma"]), x, names)
    grad_fn = _jax_grad_fn(
        lambda a: jax_ops.apply_phase(a["re"], a["im"], a["cutv"], a["gamma"]), names)
    for row in range(B):
        want = _jax_grads(grad_fn, x, names, row)
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g[row], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"d_{name}, row {row}")


def _jax_beta_vjp(kind, n, lo, nbits):
    """(outputs, ∂β) of the JAX op's ``custom_vjp`` for one row and a
    cotangent, jitted once per case."""

    def fn(a, beta, cot):
        if kind == "layer":
            def f(b):
                return jax_ops.apply_layer(a["re"], a["im"], a["cutv"], a["gamma"], b, n,
                                           group=7)
        else:
            def f(b):
                return jax_ops.apply_mixer_bits(a["re"], a["im"], n, lo, nbits, b)
        out, vjp = jax.vjp(f, beta)
        return out, vjp(cot)[0]

    return jax.jit(fn)


@pytest.mark.parametrize("kind,n,lo,nbits", [
    ("layer", 6, 0, 6), ("layer", 9, 0, 9), ("layer", 13, 0, 13),
    ("bits", 9, 2, 7), ("bits", 12, 5, 3), ("bits", 13, 7, 6), ("bits", 14, 2, 12)])
def test_beta_grad_split_matches_jax_vjp(kind, n, lo, nbits):
    """The ∂β kernel's decomposition (`ref.beta_grad_split`: groups of
    qubits, two at n = 13 and at qubits [2, 14), in-tile pair products, a
    pairwise tree, f64 sums) on the JAX
    forward's outputs and a random cotangent, against ∂β of the JAX
    ``custom_vjp`` (``_layer_bwd`` / ``_mixer_bits_bwd``: neighbour sums
    and ``jnp.sum``), within ``BETA_GRAD_RTOL · S`` a row; the plain
    version too."""
    x = _inputs(n, seed=60 + n + lo)
    vjp_fn = _jax_beta_vjp(kind, n, lo, nbits)
    with jax_ops.using_implementation("xla"):
        for row in range(B):
            a = {k: jnp.asarray(v[row]) for k, v in x.items()}
            (ore, oim), want = vjp_fn(a, a["beta"], (a["w_re"], a["w_im"]))
            planes = [torch.from_numpy(np.array(t, dtype=np.float32))[None]
                      for t in (x["w_re"][row], x["w_im"][row], ore, oim)]
            tol = float(betagrad.tolerance(*planes, lo, nbits)[0])
            for got in (ref.beta_grad_split(*planes, lo, nbits),
                        ref.beta_grad(*planes, lo, nbits)):
                assert abs(float(got[0]) - float(want)) <= tol, (kind, row, got, want, tol)
