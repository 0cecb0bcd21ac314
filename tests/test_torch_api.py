"""The last small pieces of the JAX package's API in the port, each held
against its JAX counterpart on the CPU: `qaoa.solve_subgraph` and
`qaoa.index_to_bits`, the `cutvals` / `cutvals_at` backward (the JAX
``custom_vjp`` rules) and `ref.dense_qaoa_layer`; and the dispatch by
device that stands where the reference has a kernel selection.

Gradients agree within rtol 1e-5 on a positive cotangent (every term of
the reductions has one sign, so the f32 sums differ by rounding only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import qaoa as jqaoa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.core import qaoa as tqaoa
from repro_torch.kernels import _build, ops, ref
from repro_torch.obs.ledger import get_ledger

GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(n, seed, weighted=True):
    g = (jgraph.Graph.erdos_renyi_weighted if weighted else jgraph.Graph.erdos_renyi)(
        n, 0.5, seed=seed)
    return np.array(g.edges, np.int32), np.array(g.weights, np.float32)


# ------------------------------------------------------- cutvals backward --
@pytest.mark.parametrize("n, with_linear", [(6, False), (8, True), (10, True)])
def test_cutvals_grads_match_jax(n, with_linear):
    rng = np.random.default_rng(n)
    rows = [_arrays(n, seed=int(rng.integers(1 << 20))) for _ in range(3)]
    e_pad = max(e.shape[0] for e, _ in rows)
    edges = np.zeros((3, e_pad, 2), np.int32)
    weights = np.zeros((3, e_pad), np.float32)
    for r, (e, w) in enumerate(rows):
        edges[r, :len(e)], weights[r, :len(w)] = e, w
    lin = rng.normal(size=(3, n)).astype(np.float32) if with_linear else None
    g = rng.uniform(0.1, 1.0, (3, 2**n)).astype(np.float32)

    w_t = torch.from_numpy(weights).requires_grad_(True)
    l_t = torch.from_numpy(lin).requires_grad_(True) if with_linear else None
    out = ops.cutvals(n, torch.from_numpy(edges), w_t, l_t)
    out.backward(torch.from_numpy(g))
    with jops.using_implementation("xla"):
        for r in range(3):
            if with_linear:
                f = lambda w, h: jops.cutvals(n, jnp.asarray(edges[r]), w, h)  # noqa: E731
                want, vjp = jax.vjp(f, jnp.asarray(weights[r]), jnp.asarray(lin[r]))
                d_w, d_l = vjp(jnp.asarray(g[r]))
                np.testing.assert_allclose(l_t.grad[r].numpy(), np.asarray(d_l),
                                           rtol=GRAD_RTOL)
            else:
                f = lambda w: jops.cutvals(n, jnp.asarray(edges[r]), w)  # noqa: E731
                want, vjp = jax.vjp(f, jnp.asarray(weights[r]))
                (d_w,) = vjp(jnp.asarray(g[r]))
            np.testing.assert_array_equal(out[r].detach().numpy(), np.asarray(want))
            np.testing.assert_allclose(w_t.grad[r].numpy(), np.asarray(d_w),
                                       rtol=GRAD_RTOL)
    # a padding row (0, 0, w = 0) gets no gradient, as in the reference
    pad = [r for r in range(3) if len(rows[r][0]) < e_pad]
    for r in pad:
        assert torch.all(w_t.grad[r, len(rows[r][0]):] == 0)


@pytest.mark.parametrize("with_linear", [False, True])
def test_cutvals_at_grads_match_jax(with_linear):
    n, s, width = 9, 3, 40
    rng = np.random.default_rng(7)
    edges, weights = _arrays(n, seed=3)
    idx = rng.integers(0, 2**n, (s, width)).astype(np.int32)
    lin = rng.normal(size=(n,)).astype(np.float32) if with_linear else None
    g = rng.uniform(0.1, 1.0, (2 * s, width)).astype(np.float32)
    # two edge rows: the same graph, and its weights doubled
    e_t = torch.from_numpy(np.stack([edges, edges]))
    w_t = torch.from_numpy(np.stack([weights, 2 * weights])).requires_grad_(True)
    l_t = (torch.from_numpy(np.stack([lin, lin])).requires_grad_(True)
           if with_linear else None)
    out = ops.cutvals_at(torch.from_numpy(idx), e_t, w_t, l_t)
    out.backward(torch.from_numpy(g))
    with jops.using_implementation("xla"):
        for r, scale in enumerate((1, 2)):
            args = [jnp.asarray(scale * weights)] + ([jnp.asarray(lin)] if with_linear else [])
            f = lambda *a: jops.cutvals_at(jnp.asarray(idx), jnp.asarray(edges), *a)  # noqa: E731
            want, vjp = jax.vjp(f, *args)
            grads = vjp(jnp.asarray(g[r * s:(r + 1) * s]))
            np.testing.assert_allclose(out[r * s:(r + 1) * s].detach().numpy(),
                                       np.asarray(want), rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(w_t.grad[r].numpy(), np.asarray(grads[0]),
                                       rtol=GRAD_RTOL)
            if with_linear:
                np.testing.assert_allclose(l_t.grad[r].numpy(), np.asarray(grads[1]),
                                           rtol=GRAD_RTOL)


def test_cutvals_backward_works_in_slabs(monkeypatch):
    """A slab smaller than one edge row's states gives the same gradient:
    the backward never needs the whole (B, E, 2^n) tensor."""
    n = 8
    edges, weights = _arrays(n, seed=11)
    e_t = torch.from_numpy(edges)[None].expand(2, -1, -1).contiguous()
    g = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 1, (2, 2**n)).astype(np.float32))

    def grad():
        w = torch.from_numpy(np.stack([weights, weights])).requires_grad_(True)
        ops.cutvals(n, e_t, w).backward(g)
        return w.grad

    whole = grad()
    monkeypatch.setattr(ops, "GRAD_SLAB", 2**n)
    assert torch.equal(grad(), whole)


# ------------------------------------------------ solve_subgraph and bits --
def test_index_to_bits_matches_jax():
    idx = np.random.default_rng(2).integers(0, 2**10, (3, 5)).astype(np.int32)
    got = tqaoa.index_to_bits(torch.from_numpy(idx), 10)
    want = jqaoa.index_to_bits(jnp.asarray(idx), 10)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _subgraphs(n_qubits):
    g = tgraph.Graph.erdos_renyi_weighted(30, 0.3, seed=8)
    return tpart.partition_for_solver(g, n_qubits).subgraphs


def test_solve_subgraph_is_row_zero_of_the_batch():
    cfg = tqaoa.QAOAConfig(n_qubits=7, p_layers=2, opt_steps=3, top_k=3)
    subs = _subgraphs(7)
    edges, weights, masks = tqaoa.pad_subgraph_arrays(subs, 7, n_rows=len(subs) + 2)
    batch = tqaoa.solve_subgraph_batch(edges, weights, masks, cfg)
    for r in range(2):
        one = tqaoa.solve_subgraph(edges[r], weights[r], int(masks[r]), cfg)
        for got, want in zip(one, batch):
            assert torch.equal(got, want[r])


def test_solve_subgraph_matches_jax():
    """Angles and ⟨cut⟩ within the port's tolerances; the picked bits
    carry the JAX state's marginal (ties between complements may order
    them either way)."""
    cfg_t = tqaoa.QAOAConfig(n_qubits=7, p_layers=2, opt_steps=3, top_k=3)
    cfg_j = jqaoa.QAOAConfig(n_qubits=7, p_layers=2, opt_steps=3, top_k=3)
    sub = _subgraphs(7)[0]
    e = np.zeros((sub.edges.shape[0] + 2, 2), np.int32)
    w = np.zeros(e.shape[0], np.float32)
    e[:len(sub.edges)], w[:len(sub.weights)] = sub.edges.numpy(), sub.weights.numpy()
    mask = (1 << sub.n) - 1
    got = tqaoa.solve_subgraph(torch.from_numpy(e), torch.from_numpy(w), mask, cfg_t)
    with jops.using_implementation("xla"):
        want = jqaoa.solve_subgraph(jnp.asarray(e), jnp.asarray(w), jnp.int32(mask), cfg_j)
        cutv = jops.cutvals(7, jnp.asarray(e), jnp.asarray(w))
        re, im = jqaoa.qaoa_statevector(cutv, 7, want.gammas, want.betas)
    np.testing.assert_allclose(got.gammas.numpy(), np.asarray(want.gammas), atol=1e-4)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), atol=1e-4)
    np.testing.assert_allclose(float(got.expectation), float(want.expectation), rtol=1e-5)
    probs = np.asarray(re) ** 2 + np.asarray(im) ** 2
    marg = np.zeros(2**7)
    np.add.at(marg, np.arange(2**7) & mask, probs)
    np.testing.assert_allclose(got.probs.numpy(), np.sort(np.asarray(want.probs))[::-1],
                               rtol=1e-4)
    np.testing.assert_allclose(marg[got.bitstrings.numpy()], got.probs.numpy(), rtol=1e-4)
    assert got.bitstrings.shape == (3,) and got.expectation.shape == ()


# ------------------------------------------------------ dense-unitary oracle --
@pytest.mark.parametrize("n", [3, 6, 8])
def test_dense_qaoa_layer_matches_jax(n):
    rng = np.random.default_rng(n)
    edges, weights = _arrays(n, seed=n)
    cutv = np.asarray(jops.cutvals(n, jnp.asarray(edges), jnp.asarray(weights)))
    psi = (rng.normal(size=(2, 2**n)) + 1j * rng.normal(size=(2, 2**n))).astype(np.complex64)
    gam, bet = rng.uniform(0, 1, 2).astype(np.float32), rng.uniform(0, 1, 2).astype(np.float32)
    got = ref.dense_qaoa_layer(torch.from_numpy(psi), torch.from_numpy(np.stack([cutv] * 2)),
                               torch.from_numpy(gam), torch.from_numpy(bet), n)
    for r in range(2):
        want = jref.dense_qaoa_layer(jnp.asarray(psi[r]), jnp.asarray(cutv),
                                     float(gam[r]), float(bet[r]), n)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # and the port's layer op agrees with its own oracle
    re, im = ops.apply_layer(torch.from_numpy(psi.real.copy()), torch.from_numpy(psi.imag.copy()),
                             torch.from_numpy(np.stack([cutv] * 2)), torch.from_numpy(gam),
                             torch.from_numpy(bet), n, group=min(n, 7))
    np.testing.assert_allclose((re + 1j * im).detach().numpy(), got.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="n <= 8"):
        ref.dense_qaoa_layer(torch.zeros((1, 2**9), dtype=torch.complex64),
                             torch.zeros((1, 2**9)), torch.zeros(1), torch.zeros(1), 9)


# --------------------------------------------------------------- dispatch --
def test_dispatch_follows_the_device():
    # no selection to set: a CPU tensor takes the plain version and the
    # ledger records that route; a device with neither path raises
    edges, weights = _arrays(6, seed=5)
    e, w = torch.from_numpy(edges)[None], torch.from_numpy(weights)[None]
    ledger = get_ledger()
    ledger.reset()
    got = ops.cutvals(6, e, w)
    assert torch.equal(got, ref.cutvals(6, e, w))
    assert not _build.on_cuda(e)
    assert ledger.op_traces == {("cutvals", "plain"): 1}
    with pytest.raises(ValueError, match="device"):
        _build.on_cuda(torch.zeros(1, device="meta"))
    ledger.reset()
