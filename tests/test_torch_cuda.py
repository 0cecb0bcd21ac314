"""The CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card
and skips where there is none (so here, on the CPU). On a machine with an
H100 run them with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes; the main path's shapes are ``chip_smoke.py``'s. Tolerances
as in tests/test_torch_kernels.py, plus exact cut values (the kernel adds
in edge order, as the plain version does).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_layer, mixer, ops, phase, ref
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
    rng = np.random.default_rng(n)
    edges = torch.as_tensor(rng.integers(0, n, (3, 20, 2)).astype(np.int32),
                            device=cuda_device)
    w = torch.as_tensor(rng.choice([-1.0, 1.0, 2.0], (3, 20)).astype(np.float32),
                        device=cuda_device)
    lin = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32),
                          device=cuda_device)
    for linear in (None, lin):
        got = cutvals_mod.cutvals(n, edges, w, linear)
        assert torch.equal(got, ref.cutvals(n, edges, w, linear))


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


@pytest.mark.parametrize("n", [4, 10, 15])
def test_expectation_kernel_matches_plain_and_repeats_bitwise(cuda_device, n):
    re, im, cutv, _, _ = _inputs(n, 3, n, cuda_device)
    got = phase.expectation(re, im, cutv)
    torch.testing.assert_close(got, ref.expectation(re, im, cutv), rtol=1e-5, atol=0)
    assert torch.equal(got, phase.expectation(re, im, cutv))


def test_layer_counts_one_launch_per_kernel_call(cuda_device):
    n = 16  # groups at 0 (fused), 7 and 14 (strided)
    re, im, cutv, g, b = _inputs(n, 2, 0, cuda_device)
    ops.reset_launch_counts()
    ops.apply_layer(re, im, cutv, g, b, n, 7)
    ops.expectation(re, im, cutv)
    assert ops.launch_counts() == {"cutvals": 0, "fused_phase_mixer_group": 1,
                                   "mixer_group_strided": 2, "expectation": 1}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mixer.apply_mixer_bits(re, im, n, 0, 7, b)
