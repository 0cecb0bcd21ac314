"""The decompositions behind the redesigned kernels, on the CPU.

The CUDA kernels compute the same functions as the plain versions by
another route: ``cut_batch_dense`` as bf16 tensor-core products of the
spin rows with the three bf16 planes of A (`ref.split_bf16`), ``cutvals``
and ``cutvals_at`` by lookup in per-edge-row tables
(`ref.cutvals_split_tables`), and the layer backward's ∂β as per-group
tiles of pair products (`ref.beta_grad_groups`; two reads of the planes
at n = 24, `ref.beta_grad_launches`). Their plain mirrors in
``kernels/ref.py`` carry the algebra, and are held here against the plain
versions and against the JAX package's Pallas kernels (interpret mode),
with inputs made by numpy from a seed:

- integer weights (and integer linear terms): bitwise, since every sum is
  an exact integer in f32 whatever its order;
- real weights: within the stated tolerances, ``CUT_BATCH_RTOL · Σ|A|``
  a cut value and ``CUTVALS_AT_RTOL · (Σ|w| + Σ|h|)`` of an edge row a
  state (f32 sums of the same exact terms in another order);
- ∂β: within ``BETA_GRAD_RTOL · S`` a row, S the sum of the products'
  magnitudes (`betagrad.tolerance`).

The kernels are held against these mirrors on the card by
``chip_smoke.py`` phase 2 (the cut kernels bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cutbatch as jax_cutbatch
from repro.kernels import cutvals as jax_cutvals
from repro_torch.core import engine
from repro_torch.core.axis import LocalAxis
from repro_torch.kernels import betagrad, cutbatch, ref
from repro_torch.kernels import cutvals as cutvals_mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spins(b, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (b, v)) * 2 - 1).astype(np.float32)


def _matrix(kind, v, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((v, v)).astype(np.float32)
    if kind == "integer":
        return rng.integers(-256, 257, (v, v)).astype(np.float32)
    a = (rng.random((v, v)) < 0.3).astype(np.float32)  # unit graph
    a = np.triu(a, 1)
    return a + a.T


# ---------------------------------------------------------------------------
# cut_batch_dense: three bf16 planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "integer", "unit"])
@pytest.mark.parametrize("v", [16, 37, 64])
def test_split_bf16_reconstructs_a_exactly(kind, v):
    a = _t(_matrix(kind, v, seed=v))
    planes = ref.split_bf16(a)
    assert all(p.dtype == torch.bfloat16 and p.shape == a.shape for p in planes)
    a1, a2, a3 = (p.to(torch.float32) for p in planes)
    assert torch.equal((a1 + a2) + a3, a)
    if kind != "normal":  # integers |w| <= 256 are bf16 values
        assert not a2.any() and not a3.any()
    else:
        assert a2.any() and a3.any()


def test_split_bf16_keeps_small_and_large_magnitudes():
    a = _t(np.asarray([[1e-20, -3.14159274, 1e20, 257.0]], np.float32))
    a1, a2, a3 = (p.to(torch.float32) for p in ref.split_bf16(a))
    assert torch.equal((a1 + a2) + a3, a)
    assert (float(a1[0, 3]), float(a2[0, 3])) == (256.0, 1.0)  # 257 needs 9 bits


@pytest.mark.parametrize("kind", ["unit", "integer"])
@pytest.mark.parametrize("v,b", [(16, 8), (48, 37), (64, 50)])
def test_cut_batch_dense_split_is_bitwise_on_integer_weights(kind, v, b):
    s = _t(_spins(b, v, seed=v + b))
    a = _t(_matrix(kind, v, seed=b))
    wtot = float(a.sum()) / 2
    want = ref.cut_batch_dense(s, a, wtot)
    assert torch.equal(ref.cut_batch_dense_split(s, a, wtot), want)
    assert torch.equal(cutbatch.cut_batch_dense(s, a, wtot), want)  # the CPU branch


@pytest.mark.parametrize("v,b", [(16, 8), (48, 37), (64, 50)])
def test_cut_batch_dense_split_within_tolerance_on_real_weights(v, b):
    s = _spins(b, v, seed=3 * v)
    a = _matrix("normal", v, seed=v)
    a = (a + a.T) / 2
    wtot = float(np.triu(a).sum())
    got = ref.cut_batch_dense_split(_t(s), _t(a), wtot)
    tol = cutbatch.CUT_BATCH_RTOL * float(np.abs(a).sum())
    want = ref.cut_batch_dense(_t(s), _t(a), wtot)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    jwant = jax_cutbatch.cut_batch_dense(jnp.asarray(s), jnp.asarray(a), wtot,
                                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=tol)


@pytest.mark.parametrize("v,b", [(40, 24), (64, 64)])
def test_cut_batch_dense_split_equals_pallas_on_integer_weights(v, b):
    s = _spins(b, v, seed=v)
    a = _matrix("integer", v, seed=2 * v)
    a = np.triu(a, 1) + np.triu(a, 1).T
    wtot = float(np.triu(a).sum())
    got = ref.cut_batch_dense_split(_t(s), _t(a), wtot)
    want = jax_cutbatch.cut_batch_dense(jnp.asarray(s), jnp.asarray(a), wtot,
                                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,flags", [("unit", [1, 0, 0]), ("integer", [1, 0, 0]),
                                        ("normal", [1, 1, 1]), ("zero", [0, 0, 0])])
def test_split_planes_flags_on_the_cpu(kind, flags):
    a = torch.zeros((20, 20)) if kind == "zero" else _t(_matrix(kind, 20, seed=5))
    planes, got = cutbatch.split_planes(a)
    assert got.dtype == torch.int32 and got.tolist() == flags
    assert all(torch.equal(p, q) for p, q in zip(planes, ref.split_bf16(a)))


def test_cut_batch_dense_bound_reads_the_tensor_core_rate():
    from repro_torch.roofline import analysis

    b, v = 1 << 18, 400
    flops, nbytes = 2 * b * v * v, 4 * (b * v + v * v + b)
    bound = analysis.kernel_bound_s(flops, nbytes, unit="bf16_tensor")
    assert analysis.bound_by(flops, nbytes, unit="bf16_tensor") == "bytes"
    assert bound == pytest.approx(nbytes / 3.35e12)
    b, v = 4096, 16000
    flops, nbytes = 2 * b * v * v, 4 * (b * v + v * v + b)
    assert analysis.bound_by(flops, nbytes, unit="bf16_tensor") == "operations"
    assert analysis.kernel_bound_s(flops, nbytes, unit="bf16_tensor") == pytest.approx(
        flops / 989e12)
    assert analysis.kernel_bound_s(flops, nbytes) == pytest.approx(flops / 67e12)
    for card, rate in (("NVIDIA H100 PCIe", 756e12), ("NVIDIA H100 NVL", 835e12)):
        assert analysis.bound_terms(1e12, 0, card, "bf16_tensor")[0] == pytest.approx(
            1e12 / rate)
    with pytest.raises(ValueError):
        analysis.kernel_bound_s(1.0, 1.0, unit="tf32")


# ---------------------------------------------------------------------------
# cutvals_at: T_lo, T_hi and D
# ---------------------------------------------------------------------------

def _edge_rows(n, seed, b=3, e=14, real=False):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (b, e, 2)).astype(np.int32)
    edges[:, -2:] = 0  # padding rows (0, 0, w=0)
    if real:
        w = rng.standard_normal((b, e)).astype(np.float32)
        lin = rng.standard_normal((b, n)).astype(np.float32)
    else:
        w = rng.choice(np.asarray([-1.0, 1.0, 2.0], np.float32), (b, e))
        lin = rng.integers(-3, 4, (b, n)).astype(np.float32)
    w[:, -2:] = 0.0
    return edges, w, lin


def _views(n, d):
    return engine.index_tables(engine.ShardedLayout(n=n, axis=LocalAxis(d)), "cpu")


def _split_at(idx, edges, w, lin, n):
    if lin is not None:
        edges, w = ref.append_linear_rows(edges, w, lin)
    return ref.cutvals_at_split(idx, ref.cutvals_split_tables(edges, w, n))


@pytest.mark.parametrize("n,d", [(3, 2), (6, 2), (10, 4), (12, 8)])
@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("derive_n", [False, True])
def test_cutvals_at_split_is_bitwise_on_integer_weights(n, d, linear, derive_n):
    edges, w, lin = (_t(x) for x in _edge_rows(n, seed=n + d))
    lin = lin if linear else None
    for idx in _views(n, d):  # layouts A and B
        nb = cutvals_mod.index_bits(idx) if derive_n else n
        assert nb <= n
        want = ref.cutvals_at(idx, edges, w, lin)
        assert torch.equal(_split_at(idx, edges, w, lin, nb), want)


@pytest.mark.parametrize("n,l", [(8, 3), (9, 0), (9, 9), (11, 5)])
def test_cutvals_at_split_is_bitwise_at_any_split(n, l):
    edges, w, lin = (_t(x) for x in _edge_rows(n, seed=40 + n))
    e2, w2 = ref.append_linear_rows(edges, w, lin)
    idx = _t(np.random.default_rng(n).permutation(2**n)[: 2 * 2 ** (n - 1)]
             .reshape(2, -1).astype(np.int32))
    tables = ref.cutvals_split_tables(e2, w2, n, l)
    assert [t.shape for t in tables] == [(3, 2**l), (3, 2 ** (n - l)), (3, 2 ** (n - l), l)]
    assert torch.equal(ref.cutvals_at_split(idx, tables, l),
                       ref.cutvals_at(idx, edges, w, lin))


@pytest.mark.parametrize("n,d", [(6, 2), (10, 4), (13, 8)])
def test_cutvals_at_split_within_tolerance_on_real_weights(n, d):
    edges, w, lin = (_t(x) for x in _edge_rows(n, seed=70 + n, real=True))
    scale = w.abs().sum(1) + lin.abs().sum(1)  # per edge row
    for idx in _views(n, d):
        got = _split_at(idx, edges, w, lin, n)
        want = ref.cutvals_at(idx, edges, w, lin)
        err = (got - want).abs().view(3, -1).amax(1)
        assert bool((err <= cutvals_mod.CUTVALS_AT_RTOL * scale).all()), err


@pytest.mark.parametrize("n,s", [(6, 2), (9, 4)])
@pytest.mark.parametrize("real", [False, True])
def test_cutvals_at_split_matches_pallas(n, s, real):
    """An (S, L) table of arbitrary states, n derived from its largest."""
    edges, w, lin = _edge_rows(n, seed=50 + n, real=real)
    idx = np.random.default_rng(n).permutation(2**n)[: s * 2 ** (n - 2)]
    idx = idx.reshape(s, -1).astype(np.int32)
    nb = cutvals_mod.index_bits(_t(idx))
    got = _split_at(_t(idx), _t(edges), _t(w), _t(lin), nb).numpy()
    for r in range(3):
        tol = float(cutvals_mod.CUTVALS_AT_RTOL * (np.abs(w[r]).sum() + np.abs(lin[r]).sum()))
        for q in range(s):
            want = np.asarray(jax_cutvals.cutvals_at(
                jnp.asarray(idx[q]), jnp.asarray(edges[r]), jnp.asarray(w[r]),
                jnp.asarray(lin[r]), interpret=True))
            if real:
                np.testing.assert_allclose(got[r * s + q], want, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(got[r * s + q], want)


def test_cutvals_split_tables_handle_virtual_and_out_of_range_bits():
    """Ends at bit 30 or at any bit >= n score as bits no index sets; an
    edge (i, i) and an edge between two such bits add nothing."""
    n = 7
    edges = _t(np.asarray([[[1, 30], [30, 5], [2, 9], [3, 3], [30, 8], [4, 6]]],
                          np.int32))
    w = _t(np.asarray([[1.5, -2.0, 3.0, 7.0, 11.0, 0.25]], np.float32))
    idx = _t(np.arange(2**n, dtype=np.int32)[None])
    for l in (0, 3, 7):
        tables = ref.cutvals_split_tables(edges, w, n, l)
        assert torch.equal(ref.cutvals_at_split(idx, tables, l),
                           ref.cutvals_at(idx, edges, w))


def test_index_bits_reads_the_largest_index():
    assert cutvals_mod.index_bits(_t(np.asarray([[0, 0]], np.int32))) == 1
    assert cutvals_mod.index_bits(_t(np.asarray([[5, 1], [2, 0]], np.int32))) == 3
    assert cutvals_mod.index_bits(_t(np.asarray([[8]], np.int32))) == 4
    assert cutvals_mod.index_bits(_views(12, 4)[1]) == 12


# ---------------------------------------------------------------------------
# cutvals: the fill kernel's mirror, every state in order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 8, 12, 14])
@pytest.mark.parametrize("linear", [False, True])
def test_cutvals_split_is_bitwise_on_integer_weights(n, linear):
    """Below, at and above the split's 12 low bits, with integer linear rows."""
    edges, w, lin = (_t(x) for x in _edge_rows(n, seed=90 + n))
    lin = lin if linear else None
    got = ref.cutvals_split(n, edges, w, lin)
    assert got.shape == (3, 2**n)
    assert torch.equal(got, ref.cutvals(n, edges, w, lin))
    assert torch.equal(cutvals_mod.cutvals(n, edges, w, lin), ref.cutvals(n, edges, w, lin))


@pytest.mark.parametrize("n", [5, 8, 12, 14])
def test_cutvals_split_within_tolerance_on_real_weights(n):
    edges, w, lin = (_t(x) for x in _edge_rows(n, seed=110 + n, real=True))
    scale = w.abs().sum(1) + lin.abs().sum(1)
    got = ref.cutvals_split(n, edges, w, lin)
    err = (got - ref.cutvals(n, edges, w, lin)).abs().amax(1)
    assert bool((err <= cutvals_mod.CUTVALS_AT_RTOL * scale).all()), err
    e2, w2 = ref.append_linear_rows(edges, w, lin)  # the same rows, appended first
    assert torch.equal(ref.cutvals_split(n, e2, w2), got)


@pytest.mark.parametrize("n", [6, 9, 12])
@pytest.mark.parametrize("real", [False, True])
def test_cutvals_split_matches_pallas(n, real):
    edges, w, lin = _edge_rows(n, seed=130 + n, real=real)
    got = ref.cutvals_split(n, _t(edges), _t(w), _t(lin)).numpy()
    for r in range(3):
        want = np.asarray(jax_cutvals.cutvals(n, jnp.asarray(edges[r]), jnp.asarray(w[r]),
                                              jnp.asarray(lin[r]), interpret=True))
        if real:
            tol = float(cutvals_mod.CUTVALS_AT_RTOL
                        * (np.abs(w[r]).sum() + np.abs(lin[r]).sum()))
            np.testing.assert_allclose(got[r], want, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(got[r], want)


# ---------------------------------------------------------------------------
# ∂β: the kernel's groups of qubits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,nbits", [(0, 24), (0, 26), (0, 5), (3, 9), (7, 7), (21, 3),
                                      (12, 12), (2, 23), (0, 20), (0, 12), (1, 13), (22, 2),
                                      (0, 23), (0, 22)])
def test_beta_grad_groups_cover_the_range_in_tiles(lo, nbits):
    """Consecutive groups of at most 12 qubits cover [lo, lo + nbits); a
    tile fits BETA_TILE and takes runs of at least 16 lanes (64 bytes)
    where Y allows; a launch reads the planes once for one group or for two
    adjacent groups of equal size on the same lanes, each filling its tile;
    every term has a tree leaf."""
    launches = ref.beta_grad_launches(lo, nbits)
    groups = ref.beta_grad_groups(lo, nbits)
    assert groups == [p for launch in launches for p in launch]
    assert groups[0].g0 == lo
    assert sum(p.k for p in groups) == nbits
    for p, nxt in zip(groups, groups[1:] + [ref.BetaPass(lo + nbits, 0, 0)]):
        y = 2**p.g0
        assert nxt.g0 == p.g0 + p.k and 1 <= p.k <= ref.BETA_MAX_K
        assert y % p.lanes == 0 and p.lanes >= min(y, ref.BETA_LANES)
        assert 2**p.k * p.lanes <= ref.BETA_TILE
        assert p.lanes.bit_length() - 1 + p.k <= ref.BETA_SLOTS
    for launch in launches:
        assert len(launch) in (1, 2)
        if len(launch) == 2:
            a, b = launch
            assert b.g0 == a.g0 + a.k and a.lanes == b.lanes and a.k == b.k
            assert 2**a.k * a.lanes == ref.BETA_TILE and a.lanes < 2**b.g0
    if (lo, nbits) == (0, 24):  # the main path's n: two reads of the planes
        assert launches == [((0, 12, 1),), ((12, 6, 64), (18, 6, 64))]
    if (lo, nbits) == (0, 20):  # the headline's n
        assert launches == [((0, 12, 1),), ((12, 8, 16),)]
    if (lo, nbits) == (0, 12):  # the service's n: one read
        assert launches == [((0, 12, 1),)]
    if (lo, nbits) == (0, 23):  # an odd rest above qubit 11 is not fused
        assert launches == [((0, 12, 1),), ((12, 8, 16),), ((20, 3, 512),)]
    if (lo, nbits) == (0, 22):
        assert launches == [((0, 12, 1),), ((12, 5, 128), (17, 5, 128))]


@pytest.mark.parametrize("n,lo,nbits", [(24, 0, 24), (20, 0, 20), (12, 0, 12), (4, 0, 4),
                                        (14, 7, 7), (24, 21, 3), (26, 22, 2), (26, 0, 26)])
def test_beta_pass_tiles_give_every_amplitude_one_share(n, lo, nbits):
    """Each group's tiles (its partials a row, one a tile) hold every one
    of the 2^n amplitudes once: partials × amplitudes a tile = 2^n."""
    for p in ref.beta_grad_groups(lo, nbits):
        slabs, parts = ref.beta_pass_tiles(n, p)
        per_tile = 2**p.k * p.lanes * slabs
        assert per_tile <= ref.BETA_TILE and parts * per_tile == 2**n
        assert 2 ** (n - p.g0 - p.k) % slabs == 0
    if (n, lo, nbits) == (24, 0, 24):
        assert [ref.beta_pass_tiles(n, p) for p in ref.beta_grad_groups(lo, nbits)] == \
            [(1, 4096), (1, 4096), (1, 4096)]


def _cotangents(n, seed, b=3):
    rng = np.random.default_rng(seed)
    planes = [rng.standard_normal((b, 2**n)).astype(np.float32) for _ in range(4)]
    norm = np.sqrt((planes[2] ** 2 + planes[3] ** 2).sum(1, keepdims=True))
    planes[2] /= norm  # the outputs are unit-norm states, as a mixer's are
    planes[3] /= norm
    return [_t(p) for p in planes]


@pytest.mark.parametrize("n,lo,nbits", [(4, 0, 4), (9, 0, 9), (13, 0, 13), (14, 0, 14),
                                        (10, 2, 7), (12, 5, 3), (14, 7, 7), (14, 9, 5),
                                        (16, 4, 12), (14, 1, 13)])
def test_beta_grad_split_within_tolerance_of_the_plain_version(n, lo, nbits):
    planes = _cotangents(n, seed=n + lo)
    got = ref.beta_grad_split(*planes, lo, nbits)
    want = ref.beta_grad(*planes, lo, nbits)
    tol = betagrad.tolerance(*planes, lo, nbits)
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert bool(((got - want).abs() <= tol).all()), (got - want, tol)
    # the CPU branch of the wrapper is the plain version itself
    assert torch.equal(betagrad.beta_grad(*planes, lo, nbits), want)


def test_beta_grad_tolerance_is_the_sum_of_magnitudes():
    """S = Σ_x Σ_q (|d_ore·oim'| + |d_oim·ore'|), here term by term."""
    n, lo, nbits = 5, 1, 3
    dr, di, o_re, o_im = (p.double() for p in _cotangents(n, seed=3))
    x = torch.arange(2**n)
    s = sum((dr * o_im[:, x ^ 2**q]).abs().sum(1) + (di * o_re[:, x ^ 2**q]).abs().sum(1)
            for q in range(lo, lo + nbits))
    got = betagrad.tolerance(*_cotangents(n, seed=3), lo, nbits)
    torch.testing.assert_close(got.double(), betagrad.BETA_GRAD_RTOL * s, rtol=1e-6, atol=0)
