"""The CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card
and skips where there is none (so here, on the CPU). On a machine with an
H100 run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes; the main path's shapes are ``chip_smoke.py``'s. Tolerances
as in tests/test_torch_kernels.py, plus exact cut values on integer
weights (every sum is an exact integer); the table-lookup ``cutvals`` and
``cutvals_at`` and the tensor-core ``cut_batch_dense`` add real weights in
another order than their plain versions, so there they are held to their
stated tolerances and bitwise to their CPU mirrors; the ∂β kernel to
``BETA_GRAD_RTOL · S`` and bitwise across launches, and the reversed fused
pass with the layer's gradients likewise to `ref.layer_grads_split`.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, betagrad, cutbatch, fused_layer, mixer, ops, phase, ref, tuning
from repro_torch.kernels import cutvals as cutvals_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs(n, b, seed, dev):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    re = rng.standard_normal((b, 2**n))
    im = rng.standard_normal((b, 2**n))
    norm = np.sqrt((re**2 + im**2).sum(1, keepdims=True))
    return (t(re / norm), t(im / norm), t(rng.uniform(0, n, (b, 2**n))),
            t(rng.uniform(-2, 2, b)), t(rng.uniform(-2, 2, b)))


@pytest.mark.parametrize("n", [6, 10, 13])
def test_cutvals_kernel_equals_plain(cuda_device, n):
    """The table-lookup fill kernel: bitwise on integer weights without and
    with integer linear rows; with real linear rows within CUTVALS_AT_RTOL
    of each row's Σ|w| + Σ|h| and bitwise equal to the CPU mirror; the same
    bits under every tile_b."""
    rng = np.random.default_rng(n)
    edges = torch.as_tensor(rng.integers(0, n, (3, 20, 2)).astype(np.int32),
                            device=cuda_device)
    w = torch.as_tensor(rng.choice([-1.0, 1.0, 2.0], (3, 20)).astype(np.float32),
                        device=cuda_device)
    lin = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32),
                          device=cuda_device)
    lin_int = torch.as_tensor(rng.integers(-3, 4, (3, n)).astype(np.float32),
                              device=cuda_device)
    for linear in (None, lin_int):
        got = cutvals_mod.cutvals(n, edges, w, linear)
        assert torch.equal(got, ref.cutvals(n, edges, w, linear))
    got = cutvals_mod.cutvals(n, edges, w, lin)
    err = (got - ref.cutvals(n, edges, w, lin)).abs().amax(1)
    scale = w.abs().sum(1) + lin.abs().sum(1)
    assert bool((err <= cutvals_mod.CUTVALS_AT_RTOL * scale).all())
    assert torch.equal(got.cpu(), ref.cutvals_split(n, edges.cpu(), w.cpu(), lin.cpu()))
    for tile_b in (32, 256, 2048):
        key = tuning.cache_key("cutvals", 2**n)
        with tuning.using_overrides({key: {"tile_b": tile_b}}):
            assert torch.equal(cutvals_mod.cutvals(n, edges, w, lin), got)


@pytest.mark.parametrize("n,d", [(6, 2), (10, 4), (13, 8)])
def test_cutvals_at_kernel_equals_plain_on_both_views(cuda_device, n, d):
    """The table-lookup kernel: bitwise on integer weights without and with
    integer linear rows; with real linear rows within CUTVALS_AT_RTOL of
    each edge row's Σ|w| + Σ|h| (the table order is not the edge order)
    and bitwise equal to the CPU mirror of the table design."""
    from repro_torch.core import engine
    from repro_torch.core.axis import LocalAxis

    rng = np.random.default_rng(n + d)
    edges = torch.as_tensor(rng.integers(0, n, (3, 20, 2)).astype(np.int32),
                            device=cuda_device)
    w = torch.as_tensor(rng.choice([-1.0, 1.0, 2.0], (3, 20)).astype(np.float32),
                        device=cuda_device)
    lin = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32),
                          device=cuda_device)
    lin_int = torch.as_tensor(rng.integers(-3, 4, (3, n)).astype(np.float32),
                              device=cuda_device)
    tables = engine.index_tables(engine.ShardedLayout(n=n, axis=LocalAxis(d)),
                                 cuda_device)
    for idx in tables:
        for linear in (None, lin_int):
            for n_bits in (None, n):
                got = cutvals_mod.cutvals_at(idx, edges, w, linear, n_bits=n_bits)
                assert torch.equal(got, ref.cutvals_at(idx, edges, w, linear))
        got = cutvals_mod.cutvals_at(idx, edges, w, lin, n_bits=n)
        want = ref.cutvals_at(idx, edges, w, lin)
        scale = w.abs().sum(1) + lin.abs().sum(1)
        err = (got - want).abs().view(3, -1).amax(1)
        assert bool((err <= cutvals_mod.CUTVALS_AT_RTOL * scale).all())
        e2, w2 = ref.append_linear_rows(edges, w, lin)
        mirror = ref.cutvals_at_split(idx.cpu(), ref.cutvals_split_tables(e2.cpu(),
                                                                          w2.cpu(), n))
        assert torch.equal(got.cpu(), mirror)


@pytest.mark.parametrize("n", [3, 12, 17])
def test_cutvals_table_pass_equals_its_mirror(cuda_device, n):
    rng = np.random.default_rng(n)
    edges = torch.as_tensor(rng.integers(0, n, (2, 16, 2)).astype(np.int32))
    w = torch.as_tensor(rng.standard_normal((2, 16)).astype(np.float32))
    lin = torch.as_tensor(rng.standard_normal((2, n)).astype(np.float32))
    got = cutvals_mod.split_tables(edges.to(cuda_device), w.to(cuda_device), n,
                                   lin.to(cuda_device))
    want = ref.cutvals_split_tables(*ref.append_linear_rows(edges, w, lin), n)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_cutvals_at_index_above_its_bits_traps(cuda_device, tmp_path):
    """An index at or above 2^n_bits breaks the contract: the kernel traps
    (in a child process, since a trap ends the CUDA context)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import torch\n"
            "from repro_torch.kernels import cutvals\n"
            "idx = torch.tensor([[0, 1, 2, 9]], dtype=torch.int32, device='cuda')\n"
            "e = torch.tensor([[[0, 1]]], dtype=torch.int32, device='cuda')\n"
            "w = torch.ones((1, 1), device='cuda')\n"
            "cutvals.cutvals_at(idx, e, w, n_bits=3)\n"
            "torch.cuda.synchronize()\n")
    src = str(Path(__file__).resolve().parent.parent / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**__import__("os").environ, "PYTHONPATH": src},
                          timeout=300)
    assert proc.returncode != 0


@pytest.mark.parametrize("n,k", [(4, 2), (10, 7), (13, 5)])
def test_trailing_kernel_matches_plain(cuda_device, n, k):
    re, im, _, _, b = _inputs(n, 3, 40 + n + k, cuda_device)
    got = mixer.apply_mixer_bits(re, im, n, 0, k, b)
    want = ref.apply_mixer_bits(re, im, n, 0, k, b)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,k", [(6, 3), (10, 7), (13, 5)])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_kernel_matches_plain(cuda_device, n, k, reverse):
    re, im, cutv, g, b = _inputs(n, 3, n + k, cuda_device)
    v = (3, -1, 2**k)
    args = (re.view(v), im.view(v), cutv.view(v), g, b, k)
    got = fused_layer.fused_phase_mixer_group(*args, reverse=reverse)
    want = fused_layer.fused_phase_mixer_group_plain(*args, reverse)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,lo,k", [(8, 1, 3), (10, 3, 7), (13, 7, 3), (13, 10, 3)])
def test_strided_kernel_matches_plain(cuda_device, n, lo, k):
    re, im, _, _, b = _inputs(n, 3, n + lo, cuda_device)
    got = mixer.apply_mixer_bits(re, im, n, lo, k, b)
    want = ref.apply_mixer_bits(re, im, n, lo, k, b)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=0)


# (B, X, k, Y): the shapes of both paths `mixer.strided_geometry` picks from
STRIDED_SHAPES = [
    (3, 1, 7, 2),  # block body: 8-byte runs
    (1, 3, 12, 2),  # block body, X not a power of two
    (3, 1, 12, 2**7),  # block body: k = 12 leaves 2 lanes a stage
    (1, 2, 6, 4),  # block body: the row cannot fill a stage
    (3, 64, 6, 4),  # staged: 16-byte runs, 32 x a tile
    (3, 96, 6, 4),  # staged, X not a power of two
    (3, 64, 1, 2**7),  # staged: 32 x a tile
    (1, 1, 1, 2**12),  # staged: one row of 4096 lanes
    (3, 2, 3, 2**12),  # staged: 1024 lanes of 4096
    (3, 4, 6, 2**7),  # staged: the tile is the (b, x) slab
    (3, 2, 7, 2**7),  # staged: the n 20 layer's bit 7, 64 lanes of 128
    (3, 3, 7, 2**12),  # staged, X = 3
    (1, 2, 10, 2**4),  # staged: 8 lanes, two round trips
    (3, 1, 11, 2**7),  # staged: 4 lanes, three round trips
    (3, 1, 3, 2**19),  # staged: 1024 lanes in boxes of 256
    (1, 1, 7, 2**19),  # staged: the n 26 layer's bit 19 group on one row
]


@pytest.mark.parametrize("b,x,k,y", STRIDED_SHAPES)
def test_strided_kernel_on_both_paths(cuda_device, b, x, k, y):
    """`mixer_group_strided` on the path `mixer.strided_geometry` picks,
    against `ref.mixer_group` within 1e-5 of the largest amplitude; the same
    bits on a second launch and for each row alone; the group at −β
    undoes it within the same tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(131 * b + 17 * x + 7 * k + y)
    shape = (b, x, 2**k, y)
    re, im = (torch.randn(shape, generator=gen, device=cuda_device) for _ in range(2))
    beta = 4 * torch.rand(b, generator=gen, device=cuda_device) - 2
    staged, _ = mixer.strided_geometry(x, y, k, cuda_device)
    ops.reset_launch_counts()
    got = mixer.mixer_group_strided(re, im, beta, k)
    assert ops.launch_counts()["mixer_strided_staged"] == int(staged)
    _close_to_scale(got, ref.mixer_group(re, im, beta, k))
    again = mixer.mixer_group_strided(re, im, beta, k)
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    for r in range(b):
        alone = mixer.mixer_group_strided(re[r:r + 1], im[r:r + 1], beta[r:r + 1], k)
        assert all(torch.equal(p, q[r:r + 1]) for p, q in zip(alone, got))
    _close_to_scale(mixer.mixer_group_strided(*got, -beta, k), (re, im))


@pytest.mark.parametrize("x,k,y,block_lanes", [(2, 7, 2**12, 32), (1, 3, 2**12, 512),
                                                (64, 6, 4, 2)])
def test_strided_paths_give_the_same_bits(cuda_device, x, k, y, block_lanes):
    """The staged path and the block body (under a tuned tile that cannot
    fill a stage) apply the same butterflies, qubit 0 first: the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(x + k + y)
    re, im = (torch.randn((3, x, 2**k, y), generator=gen, device=cuda_device)
              for _ in range(2))
    beta = 4 * torch.rand(3, generator=gen, device=cuda_device) - 2
    assert mixer.strided_geometry(x, y, k, cuda_device)[0]
    staged = mixer.mixer_group_strided(re, im, beta, k)
    table = {tuning.cache_key("mixer_strided", x * y): {"tile_y": block_lanes}}
    with tuning.using_overrides(table):
        assert mixer.strided_geometry(x, y, k, cuda_device) == (False, block_lanes)
        block = mixer.mixer_group_strided(re, im, beta, k)
    assert all(torch.equal(p, q) for p, q in zip(staged, block))


@pytest.mark.parametrize("n", [4, 10, 15])
def test_expectation_kernel_matches_plain_and_repeats_bitwise(cuda_device, n):
    re, im, cutv, _, _ = _inputs(n, 3, n, cuda_device)
    got = phase.expectation(re, im, cutv)
    torch.testing.assert_close(got, ref.expectation(re, im, cutv), rtol=1e-5, atol=0)
    assert torch.equal(got, phase.expectation(re, im, cutv))


@pytest.mark.parametrize("n", [4, 10, 15])
def test_phase_grad_kernel_matches_plain_and_ignores_the_batch(cuda_device, n):
    """Within 1e-5 of the plain version, the same bits on a second launch,
    and each row's bits the same alone as in a batch of 17 rows (a torch
    reduction picks its order from the row count)."""
    re, im, cutv, _, _ = _inputs(n, 17, 40 + n, cuda_device)
    g_re, g_im, _, _, _ = _inputs(n, 17, 60 + n, cuda_device)
    got = phase.phase_grad(re, im, g_re, g_im, cutv)
    want = ref.phase_grad(re, im, g_re, g_im, cutv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, phase.phase_grad(re, im, g_re, g_im, cutv))
    for rows in (slice(0, 1), slice(3, 7), slice(0, 16)):
        part = phase.phase_grad(re[rows], im[rows], g_re[rows], g_im[rows], cutv[rows])
        assert torch.equal(part, got[rows])


def test_layer_counts_one_launch_per_kernel_call(cuda_device):
    n = 16  # the layer: fused [0, 9), strided [9, 16) (`ops.layer_passes`)
    re, im, cutv, g, b = _inputs(n, 2, 0, cuda_device)
    ops.reset_launch_counts()
    ops.apply_layer(re, im, cutv, g, b, n, 7)
    ops.expectation(re, im, cutv)
    ops.apply_mixer(re, im, n, b, 7)  # the trailing group, then 2 strided
    assert ops.launch_counts() == {
        "cutvals": 0, "cutvals_at": 0, "fused_phase_mixer_group": 1,
        "mixer_group_strided": 3, "mixer_group_trailing": 1, "expectation": 1,
        "apply_phase": 0, "cut_batch_dense": 0, "beta_grad": 0, "phase_grad": 0,
        "fused_layer_grads": 0, "mixer_strided_staged": 3}  # every strided group staged


def _card_inputs(n, b, seed, dev):
    """As `_inputs`, drawn on the card (rows of up to 2^26 amplitudes)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    re = torch.randn((b, 2**n), generator=gen, device=dev)
    im = torch.randn((b, 2**n), generator=gen, device=dev)
    norm = torch.sqrt((re * re + im * im).sum(1, keepdim=True))
    cutv = n * torch.rand((b, 2**n), generator=gen, device=dev)
    ang = 4 * torch.rand((2, b), generator=gen, device=dev) - 2
    return re / norm, im / norm, cutv, ang[0], ang[1]


def _close_to_scale(got, want, rtol=1e-5):
    """Planes within ``rtol`` of the largest |want|: the dense 2^k-term
    product against k butterflies, in f32."""
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=rtol * float(y.abs().max()), rtol=0)


@pytest.mark.parametrize("k", [8, 10, 12])
@pytest.mark.parametrize("rows", [1, 16, 2**14])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_kernel_at_the_plan_widths_matches_plain(cuda_device, k, rows, reverse):
    """The fused pass at the widths `ops.layer_passes` gives it, up to the
    whole 4096-amplitude tile: one row a block at k = 12, several below."""
    b = 2
    n = k + rows.bit_length() - 1
    re, im, cutv, g, beta = _card_inputs(n, b, 100 * k + n, cuda_device)
    v = (b, rows, 2**k)
    args = (re.view(v), im.view(v), cutv.view(v), g, beta, k)
    got = fused_layer.fused_phase_mixer_group(*args, reverse=reverse)
    _close_to_scale(got, fused_layer.fused_phase_mixer_group_plain(*args, reverse))


def test_layer_at_26_qubits_matches_the_plain_path(cuda_device, monkeypatch):
    """`apply_layer` at n = 26 in the plan's passes (fused [0, 12), strided
    [12, 19) and [19, 26)), forward and backward, against the plain
    versions on the same card along the reference's split (7 + 7 + 7 + 5):
    the planes and the cotangent planes within 1e-5 of their largest
    amplitude, ∂β within `betagrad.tolerance`, ∂γ within 1e-5 of
    Σ|c|·(|im·ḡre| + |re·ḡim|) a row."""
    n, b = 26, 2
    re, im, cutv, g, beta = _card_inputs(n, b, 7, cuda_device)
    d_re, d_im, _, _, _ = _card_inputs(n, b, 8, cuda_device)

    def run():
        args = [t.clone().requires_grad_(True) for t in (re, im, g, beta)]
        out = ops.apply_layer(args[0], args[1], cutv, args[2], args[3], n, 7)
        grads = torch.autograd.grad(out, args, (d_re, d_im))
        return [o.detach() for o in out], grads

    got, got_g = run()
    with monkeypatch.context() as m:
        m.setattr(_build, "on_cuda", lambda t: False)
        want, want_g = run()
    _close_to_scale(got, want)
    _close_to_scale(got_g[:2], want_g[:2])
    g_re, g_im = want_g[:2]
    scale = (cutv.abs() * ((im * g_re).abs() + (re * g_im).abs())).sum(-1)
    assert bool(((got_g[2] - want_g[2]).abs() <= 1e-5 * scale).all())
    tol = betagrad.tolerance(d_re, d_im, *want, 0, n)
    assert bool(((got_g[3] - want_g[3]).abs() <= tol).all())


@pytest.mark.parametrize("n", [12, 14, 24, 26])
def test_fused_layer_grads_match_the_mirror_and_repeat_bitwise(cuda_device, n):
    """The reversed fused pass with the gradients, at the width the layer
    runs it (`ops.layer_passes`: k = 12, 7, 10, 12), against
    `ref.layer_grads_split` on the same card from the pass's own w (the
    reversed pass at γ = 0) : ∂β over qubits [0, k) within
    ``BETA_GRAD_RTOL · S``, ∂γ within 1e-5 of Σ|c|·(|im·ḡre| + |re·ḡim|) a
    row, the planes those of the pass without the gradients; the same bits
    on a rerun, and for rows alone as in the batch."""
    b = 3
    k = ops.layer_passes(n, 7)[0]
    re, im, cutv, g, beta = _card_inputs(n, b, 40 + n, cuda_device)
    d_re, d_im, _, _, _ = _card_inputs(n, b, 50 + n, cuda_device)
    v = (b, -1, 2**k)

    def run(rows):
        tiles = fused_layer.grad_tiles(2 ** (n - k), k, cuda_device)
        bp = torch.empty((len(range(b)[rows]), tiles), dtype=torch.float64, device=cuda_device)
        gp = torch.empty_like(bp)
        planes = fused_layer.fused_layer_grads(
            *(t[rows].view(bp.shape[0], -1, 2**k) for t in (d_re, d_im, cutv)), -g[rows],
            -beta[rows], k, re[rows].view(bp.shape[0], -1, 2**k),
            im[rows].view(bp.shape[0], -1, 2**k), bp, gp)
        return planes, betagrad.final_sum(gp), betagrad.final_sum(bp)

    (g_re, g_im), d_gamma, d_beta = got = run(slice(None))
    args = (d_re.view(v), d_im.view(v), cutv.view(v), -g, -beta, k)
    _close_to_scale((g_re, g_im), fused_layer.fused_phase_mixer_group(*args, reverse=True))
    w = fused_layer.fused_phase_mixer_group(*args[:3], torch.zeros_like(g), -beta, k,
                                            reverse=True)
    w = [t.reshape(b, -1) for t in w]
    want_gamma, want_beta = ref.layer_grads_split(*w, re, im, cutv, g, k)
    v_re, v_im = ref.apply_phase(re, im, cutv, g)
    tol = betagrad.tolerance(*w, v_re, v_im, 0, k)
    assert bool(((d_beta - want_beta).abs() <= tol).all()), (d_beta, want_beta, tol)
    g_re, g_im = g_re.reshape(b, -1), g_im.reshape(b, -1)
    scale = (cutv.abs() * ((im * g_re).abs() + (re * g_im).abs())).sum(-1)
    assert bool(((d_gamma - want_gamma).abs() <= 1e-5 * scale).all())
    again = run(slice(None))
    assert all(torch.equal(x, y) for x, y in zip((*got[0], *got[1:]), (*again[0], *again[1:])))
    for rows in (slice(0, 1), slice(1, 3)):
        (p_re, p_im), p_gamma, p_beta = run(rows)
        assert torch.equal(p_gamma, d_gamma[rows]) and torch.equal(p_beta, d_beta[rows])
        assert torch.equal(p_re.reshape(-1), got[0][0][rows].reshape(-1))
        assert torch.equal(p_im.reshape(-1), got[0][1][rows].reshape(-1))


def test_layer_at_26_qubits_launches_three_passes_each_way(cuda_device):
    """One fused and two strided launches forward, the same again in the
    adjoint, whose fused launch writes ∂γ and the ∂β of qubits 0–11; ∂β of
    qubits 12–25 in one read of its own, and no ∂γ kernel. Every strided
    launch takes the staged path."""
    n = 26
    re, im, cutv, g, b = _card_inputs(n, 1, 9, cuda_device)
    args = [t.clone().requires_grad_(True) for t in (re, im, g, b)]
    ops.reset_launch_counts()
    out = ops.apply_layer(args[0], args[1], cutv, args[2], args[3], n, 7)
    forward = ops.launch_counts()
    torch.autograd.grad(out, args, (re, im))
    both = ops.launch_counts()
    none = dict.fromkeys(ops.KERNELS, 0)
    assert forward == {**none, "fused_phase_mixer_group": 1, "mixer_group_strided": 2,
                       "mixer_strided_staged": 2}
    assert both == {**none, "fused_phase_mixer_group": 2, "mixer_group_strided": 4,
                    "beta_grad": 1, "fused_layer_grads": 1, "mixer_strided_staged": 4}
    assert both["mixer_strided_staged"] == both["mixer_group_strided"]


@pytest.mark.parametrize("schedule", ["faithful", "alternating"])
def test_sharded_qaoa_on_the_card_matches_the_cpu(cuda_device, schedule):
    from repro_torch.core.axis import LocalAxis
    from repro_torch.core.distributed import sharded_qaoa
    from repro_torch.core.graph import Graph
    from repro_torch.core.qaoa import linear_ramp_init

    g = Graph.erdos_renyi(12, 0.5, seed=1)
    g0, b0 = linear_ramp_init(3, 0.75)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        ops.reset_launch_counts()
        runs.append(sharded_qaoa(g.edges.to(dev), g.weights.to(dev), 12, g0.to(dev),
                                 b0.to(dev), LocalAxis(4), schedule=schedule,
                                 opt_steps=2))
        if dev.type == "cuda":
            counts = ops.launch_counts()
    n_cut = 2 if schedule == "alternating" else 1
    assert counts["cutvals_at"] == n_cut
    assert counts["fused_phase_mixer_group"] > 0 and counts["mixer_group_strided"] > 0
    card, cpu = runs
    for a, c in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(a.cpu(), c, atol=1e-5, rtol=1e-5)
    # complement pairs tie exactly in exact arithmetic: the last ulp may
    # order them either way
    mask = (1 << 12) - 1
    assert ({min(int(x), int(x) ^ mask) for x in card.bitstrings.cpu()}
            == {min(int(x), int(x) ^ mask) for x in cpu.bitstrings})


@pytest.mark.parametrize("n", [4, 10, 15])
def test_apply_phase_kernel_matches_plain(cuda_device, n):
    re, im, cutv, g, _ = _inputs(n, 3, 70 + n, cuda_device)
    got = phase.apply_phase(re, im, cutv, g)
    want = ref.apply_phase(re, im, cutv, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,v", [(37, 48), (300, 300), (5, 129)])
def test_cut_batch_dense_kernel_equals_plain(cuda_device, b, v):
    """Unweighted: exact against the plain version and the edge-list cut;
    weighted: within 1e-5 of Σ|w|, and within CUT_BATCH_RTOL · Σ|A| of the
    plain version. B and V divide no tile."""
    from repro_torch.core.graph import Graph, cut_value_batch

    rng = np.random.default_rng(b + v)
    s = torch.as_tensor((rng.integers(0, 2, (b, v)) * 2 - 1).astype(np.float32),
                        device=cuda_device)
    x = ((s + 1) / 2).to(torch.int32)
    for g in (Graph.erdos_renyi(v, 0.3, seed=v),
              Graph.erdos_renyi_weighted(v, 0.3, seed=v)):
        adj = g.dense_adjacency(cuda_device)
        w = g.total_weight().to(cuda_device)
        got = cutbatch.cut_batch_dense(s, adj, w)
        tol = 1e-5 * float(g.weights.abs().sum())
        for want in (ref.cut_batch_dense(s, adj, w), cut_value_batch(g, x)):
            if bool(torch.all(g.weights == torch.round(g.weights))):
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, atol=tol, rtol=0)
        stated = cutbatch.CUT_BATCH_RTOL * float(adj.abs().sum())
        torch.testing.assert_close(got, ref.cut_batch_dense(s, adj, w), atol=stated,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["unit", "integer", "real", "zero"])
def test_cut_batch_dense_planes_and_knobs(cuda_device, kind):
    """The split planes equal `ref.split_bf16` with the flags of their
    nonzero entries; every (batch_tile, k_chunk) gives the same bits, on
    real weights too."""
    rng = np.random.default_rng(3)
    b, v = 150, 70
    a = {"unit": (rng.random((v, v)) < 0.3), "integer": rng.integers(-256, 257, (v, v)),
         "real": rng.standard_normal((v, v)), "zero": np.zeros((v, v))}[kind]
    adj = torch.as_tensor(a.astype(np.float32), device=cuda_device)
    s = torch.as_tensor((rng.integers(0, 2, (b, v)) * 2 - 1).astype(np.float32),
                        device=cuda_device)
    planes, flags = cutbatch.split_planes(adj)
    want = ref.split_bf16(adj.cpu())
    assert all(torch.equal(p.cpu(), q) for p, q in zip(planes, want))
    assert flags.tolist() == [int(bool(q.any())) for q in want]
    runs = []
    for bt in cutbatch.BATCH_TILES:
        for kc in cutbatch.K_CHUNKS:
            key = tuning.cache_key("cut_batch_dense", v)
            with tuning.using_overrides({key: {"batch_tile": bt, "k_chunk": kc}}):
                runs.append(cutbatch.cut_batch_dense(s, adj, 1.0))
    assert all(torch.equal(r, runs[0]) for r in runs)
    if kind != "real":
        assert torch.equal(runs[0], ref.cut_batch_dense(s, adj, 1.0))


def test_tile_candidates_give_the_same_bits(cuda_device):
    """A knob changes the launch geometry, never the math: the elementwise
    phase and the strided butterflies give the same bits under two tiles."""
    n = 14
    re, im, cutv, g, b = _inputs(n, 3, 5, cuda_device)
    v4 = (3, 2 ** (n - 14), 2**7, 2**7)
    runs = []
    for tile, tile_y in ((4096, 32), (256, 4)):
        table = {tuning.cache_key("apply_phase", 2**n): {"tile": tile},
                 tuning.cache_key("mixer_strided", 2**7): {"tile_y": tile_y}}
        with tuning.using_overrides(table):
            runs.append(phase.apply_phase(re, im, cutv, g)
                        + mixer.mixer_group_strided(re.view(v4), im.view(v4), b, 7))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n,lo,nbits", [(4, 0, 4), (13, 0, 13), (16, 0, 16), (14, 2, 7),
                                        (15, 5, 9), (16, 13, 3), (17, 9, 8), (18, 0, 18),
                                        (19, 5, 14), (21, 6, 12), (2, 0, 2), (1, 0, 1),
                                        (22, 0, 22), (23, 0, 23)])
def test_beta_grad_kernel_matches_plain_and_repeats_bitwise(cuda_device, n, lo, nbits):
    """Within BETA_GRAD_RTOL · S of the plain version a row, at ragged
    lo_bit and nbits (groups of every lane width), and the same bits on a
    second launch."""
    re, im, _, _, _ = _inputs(n, 3, 90 + n + lo, cuda_device)
    d_re, d_im, _, _, _ = _inputs(n, 3, 190 + n + lo, cuda_device)
    ops.reset_launch_counts()
    got = betagrad.beta_grad(d_re, d_im, re, im, lo, nbits)
    again = betagrad.beta_grad(d_re, d_im, re, im, lo, nbits)
    want = ref.beta_grad(d_re, d_im, re, im, lo, nbits)
    tol = betagrad.tolerance(d_re, d_im, re, im, lo, nbits)
    assert ops.launch_counts()["beta_grad"] == 2
    assert bool(((got - want).abs() <= tol).all()), (got - want, tol)
    assert torch.equal(got, again)
    mirror = ref.beta_grad_split(d_re.cpu(), d_im.cpu(), re.cpu(), im.cpu(), lo, nbits)
    assert bool(((got.cpu() - mirror).abs() <= tol.cpu()).all())


@pytest.mark.parametrize("n,lo,nbits", [(13, 0, 13), (16, 0, 16), (18, 0, 18), (18, 6, 12)])
def test_beta_grad_rows_alone_equal_the_batch_bitwise(cuda_device, n, lo, nbits):
    """A row's partials have places set by its tiles alone, so its ∂β has
    the same bits alone, in part of the batch and in the whole batch (the
    last case runs two groups fused in one launch)."""
    re, im, _, _, _ = _inputs(n, 5, 40 + n + lo, cuda_device)
    d_re, d_im, _, _, _ = _inputs(n, 5, 140 + n + lo, cuda_device)
    got = betagrad.beta_grad(d_re, d_im, re, im, lo, nbits)
    for rows in (slice(0, 1), slice(2, 5), slice(4, 5)):
        part = betagrad.beta_grad(d_re[rows], d_im[rows], re[rows], im[rows], lo, nbits)
        assert torch.equal(part, got[rows]), rows


def _service_batch(dev, n_qubits, rows, seed):
    """A dispatch as the service pads it: edges at the bucket's capacity,
    filler rows, the masks on the host."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import partition_for_solver
    from repro_torch.service import edge_capacity

    subs = partition_for_solver(Graph.erdos_renyi(40, 0.2, seed=seed), n_qubits).subgraphs
    return qaoa_mod.pad_subgraph_arrays(subs[:rows], n_qubits, e_pad=edge_capacity(n_qubits),
                                        n_rows=rows, device=dev)


def test_graphed_dispatch_equals_eager_bitwise(cuda_device):
    """The local backend's CUDA graph runs the eager path's kernels in its
    order: every output bit for bit, on the batch it was captured on and on
    another one replayed through the same graph."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.service import backend

    qcfg = qaoa_mod.QAOAConfig(n_qubits=8, p_layers=2, opt_steps=5, top_k=2)
    backend.clear_graphs()
    local = backend.LocalBackend("cuda")
    for seed in (0, 1):
        e, w, m = _service_batch(cuda_device, 8, 16, seed)
        want = qaoa_mod.solve_subgraph_batch(e, w, m, qcfg)
        got = local.solve_batch(qcfg, e, w, m)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert backend.graph_count() == 1


def test_a_capture_under_a_recording_tracer_records_no_event(cuda_device):
    """Under a recording tracer the backend's capture of
    `qaoa.solve_batch_on_device` succeeds and leaves no CUDA event to
    resolve: only the uncaptured warm-up runs on the side stream do (a
    cost table, the steps and a final state each), and they resolve."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.obs import trace
    from repro_torch.service import backend

    qcfg = qaoa_mod.QAOAConfig(n_qubits=8, p_layers=2, opt_steps=3, top_k=2)
    e, w, m = _service_batch(cuda_device, 8, 16, 3)
    backend.clear_graphs()
    tr = trace.Tracer(record=True)
    with trace.use_tracer(tr):
        got = backend.LocalBackend("cuda").solve_batch(qcfg, e, w, m)
    assert backend.graph_count() == 1
    assert len(tr._pending) == backend.GRAPH_WARMUP * (qcfg.opt_steps + 2)
    tr.resolve_device()
    timed = [s for s in tr.spans if "device_t0" in s.attrs]
    assert len(timed) == backend.GRAPH_WARMUP * (qcfg.opt_steps + 2)
    assert all(0 <= s.device_s for s in timed)
    want = qaoa_mod.solve_subgraph_batch(e, w, m, qcfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_traced_solve_places_device_intervals_inside_their_stage(cuda_device):
    """A traced solve at a small size: every device interval lies inside
    its parent's host interval (``solve_pool`` for the one QAOA round); on
    the card the round holds its cost table, the steps in step order, the
    final state and the top-K, which run one after another without
    overlap; the parts close on the QAOA stage and the merge's on the
    merge."""
    from repro_torch.core import graph, paraqaoa
    from repro_torch.obs import trace

    g = graph.Graph.erdos_renyi(60, 0.3, seed=3)
    cfg = paraqaoa.ParaQAOAConfig(n_qubits=12, opt_steps=5)
    paraqaoa.solve(g, cfg, device=cuda_device)  # builds and warms up
    tr = trace.Tracer(record=True)
    with trace.use_tracer(tr):
        out = paraqaoa.solve(g, cfg, device=cuda_device)
    by_id = {s.span_id: s for s in tr.spans}
    (rnd,) = [s for s in tr.spans if s.name == "qaoa_round"]
    timed = sorted((s for s in tr.spans if "device_t0" in s.attrs and s is not rnd),
                   key=lambda s: s.attrs["device_t0"])
    assert [s.name for s in timed] == (["cost_table"] + ["adam_step"] * cfg.opt_steps
                                       + ["final_state", "top_k"])
    assert [s.attrs["step"] for s in timed[1:-2]] == list(range(cfg.opt_steps))
    for s in timed + [rnd]:
        parent = by_id[s.parent_id]
        assert parent.name == ("solve_pool" if s is rnd else "qaoa_round")
        assert parent.t0 <= s.attrs["device_t0"] <= s.attrs["device_t1"] <= parent.t1
    for a, b in zip(timed, timed[1:]):
        assert a.attrs["device_t1"] <= b.attrs["device_t0"]
    assert (rnd.attrs["device_t0"] <= timed[0].attrs["device_t0"]
            and timed[-1].attrs["device_t1"] <= rnd.attrs["device_t1"])
    t = out.timings
    assert (t["round_gap_s"], t["qaoa_round_s"]) == (0, rnd.device_s)
    assert cfg.opt_steps * t["adam_step_s"] + t["qaoa_tail_s"] <= t["solve_s"]
    assert t["merge_plan_s"] + t["merge_scan_s"] <= t["merge_s"]
    assert not any("device_t0" in s.attrs for s in tr.spans
                   if s.name in ("merge_plan", "merge_scan", "report"))


def test_graph_replay_counts_the_eager_launches(cuda_device):
    """A replay adds what its eager counterpart would: each kernel's
    launches and each op's ledger notes."""
    from repro_torch.core import qaoa as qaoa_mod
    from repro_torch.obs.ledger import get_ledger
    from repro_torch.service import backend

    qcfg = qaoa_mod.QAOAConfig(n_qubits=8, p_layers=2, opt_steps=3)
    e, w, m = _service_batch(cuda_device, 8, 16, 2)
    local = backend.LocalBackend("cuda")
    local.solve_batch(qcfg, e, w, m)  # captured here, if it was not yet
    counts = []
    for run in (lambda: qaoa_mod.solve_subgraph_batch(e, w, m, qcfg),
                lambda: local.solve_batch(qcfg, e, w, m)):
        ops.reset_launch_counts()
        get_ledger().reset()
        run()
        counts.append((ops.launch_counts(), dict(get_ledger().op_traces)))
    assert counts[0] == counts[1]
    # at n = 8 the fused pass holds every qubit: its reversed launch writes
    # ∂γ and ∂β, and no other gradient kernel runs
    assert counts[0][0]["fused_layer_grads"] == qcfg.opt_steps * qcfg.p_layers
    assert counts[0][0]["beta_grad"] == counts[0][0]["phase_grad"] == 0


def test_a_built_service_has_every_grid_bucket_and_its_drain_captures_none(cuda_device):
    """The service captures every bucket of its planner's grid when it is
    built (a capture synchronises the card); a drain then replays only."""
    from repro_torch.core.graph import Graph
    from repro_torch.service import ServiceConfig, SolveService, backend

    backend.clear_graphs()
    svc = SolveService(ServiceConfig(batch_slots=16, max_qubits=8, device="cuda"))
    graphs = backend.graph_count()
    # a graph a bucket but for top_k, which the graph leaves out
    assert graphs == len({(q.n_qubits, q.opt_steps, q.p_layers, lin)
                          for q, _, lin in svc._grid_buckets()})
    for seed in range(3):
        svc.submit(Graph.erdos_renyi(30, 0.2, seed=seed))
    svc.drain()
    assert backend.graph_count() == graphs and svc.stats.dispatches >= 1


def test_layer_backward_launches_the_beta_grad_kernel(cuda_device):
    """The layer's and a mixer group's backward each launch ∂β once (the
    layer's over its strided qubits 7–13, the fused pass's 0–6 in its
    reversed launch), and their ∂β matches the plain version's."""
    n = 14
    re, im, cutv, g, b = _inputs(n, 2, 11, cuda_device)
    b = b.clone().requires_grad_(True)
    ops.reset_launch_counts()
    out = ops.apply_layer(re, im, cutv, g, b, n, 7)
    (d_layer,) = torch.autograd.grad(out[0].sum() + 2 * out[1].sum(), b)
    out = ops.apply_mixer_bits(re, im, n, 3, 6, b)
    (d_bits,) = torch.autograd.grad(out[0].sum() - out[1].sum(), b)
    assert ops.launch_counts()["beta_grad"] == 2
    assert ops.launch_counts()["fused_layer_grads"] == 1
    bp = b.detach().requires_grad_(True)
    out = ref.apply_mixer(*ref.apply_phase(re, im, cutv, g), n, bp, 7)
    (want,) = torch.autograd.grad(out[0].sum() + 2 * out[1].sum(), bp)
    torch.testing.assert_close(d_layer, want, rtol=1e-4, atol=1e-5)
    out = ref.apply_mixer_bits(re, im, n, 3, 6, bp)
    (want,) = torch.autograd.grad(out[0].sum() - out[1].sum(), bp)
    torch.testing.assert_close(d_bits, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the refinement, the oracle and the headline solve's n = 20 shapes
# ---------------------------------------------------------------------------

def test_refine_on_the_card_repeats_and_equals_the_cpu(cuda_device):
    """Unit weights: the card's flips equal the CPU's (integer gains);
    real weights: two card runs give the same bits, the value within
    1e-5·Σ|w| of the CPU's."""
    from repro_torch.core.baselines.local_search import refine
    from repro_torch.core.graph import Graph

    rng = np.random.default_rng(0)
    a0 = rng.integers(0, 2, 300).astype(np.int8)
    g = Graph.erdos_renyi(300, 0.05, seed=1)
    card = refine(g, a0, 150, device=cuda_device)
    cpu = refine(g, a0, 150, device="cpu")
    assert np.array_equal(card[0], cpu[0]) and card[1] == cpu[1]
    gw = Graph.erdos_renyi_weighted(300, 0.05, seed=2)
    runs = [refine(gw, a0, 150, device=cuda_device) for _ in range(2)]
    assert np.array_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    _, v_cpu = refine(gw, a0, 150, device="cpu")
    assert abs(runs[0][1] - v_cpu) <= 1e-5 * float(gw.weights.abs().sum())


@pytest.mark.parametrize("n", [12, 17])
def test_brute_force_on_the_card_equals_the_cpu(cuda_device, n):
    from repro_torch.core.baselines import brute_force
    from repro_torch.core.graph import Graph, Problem

    g = Graph.erdos_renyi(n, 0.4, seed=n)
    card = brute_force.brute_force_maxcut(g, chunk_qubits=10, device=cuda_device)
    cpu = brute_force.brute_force_maxcut(g, chunk_qubits=10, device="cpu")
    assert np.array_equal(card[0], cpu[0]) and card[1] == cpu[1]
    mis = Problem.mis(g)
    card = brute_force.brute_force_problem(mis, chunk_qubits=10, device=cuda_device)
    cpu = brute_force.brute_force_problem(mis, chunk_qubits=10, device="cpu")
    assert np.array_equal(card[0], cpu[0]) and card[1] == cpu[1]


def test_gw_on_the_card_repeats_bitwise(cuda_device):
    from repro_torch.core.baselines import gw
    from repro_torch.core.graph import Graph

    g = Graph.erdos_renyi_weighted(200, 0.1, seed=3)
    runs = [gw.goemans_williamson(g, steps=50, device=cuda_device) for _ in range(2)]
    assert np.array_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]


def test_state_kernels_at_the_headline_width(cuda_device):
    """n = 20 as the 16,000-vertex solve runs it: the fused group [0, 7),
    the strided groups [7, 14) and [14, 20) (k = 6), the expectation and ∂β
    over all 20 qubits, each against its plain version."""
    n = 20
    re, im, cutv, g, b = _inputs(n, 2, 20, cuda_device)
    v3 = (2, 2**n // 128, 128)
    got = fused_layer.fused_phase_mixer_group(re.view(v3), im.view(v3), cutv.view(v3),
                                              g, b, 7)
    want = fused_layer.fused_phase_mixer_group_plain(re.view(v3), im.view(v3),
                                                     cutv.view(v3), g, b, 7, False)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=2e-5, rtol=0)
    for lo, k in ((7, 7), (14, 6)):
        shape = (2, 2 ** (n - lo - k), 2**k, 2**lo)
        got = mixer.mixer_group_strided(re.view(shape), im.view(shape), b, k)
        want = ref.mixer_group(re.view(shape), im.view(shape), b, k)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, atol=2e-5, rtol=0)
    torch.testing.assert_close(phase.expectation(re, im, cutv),
                               ref.expectation(re, im, cutv), rtol=1e-5, atol=0)
    d_re, d_im, _, _, _ = _inputs(n, 2, 21, cuda_device)
    got = betagrad.beta_grad(d_re, d_im, re, im, 0, n)
    tol = betagrad.tolerance(d_re, d_im, re, im, 0, n)
    assert bool(((got - ref.beta_grad(d_re, d_im, re, im, 0, n)).abs() <= tol).all())
