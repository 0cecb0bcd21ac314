"""The layer's passes over the state on the card (`ops.layer_passes`): the
fused phase-and-mixer pass takes every low qubit its 4096-amplitude tile
holds, so that the fewest strided passes are left above it. The plan is
a function of (n, group) alone; CPU tensors keep the reference's split
(`ops.passes_on`), and here the plain versions are run along the plan
instead."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _fewest(n, group):
    return 1 + -(-max(0, n - ops.FUSED_MAX_K) // group)


@pytest.mark.parametrize("group", [3, 5, 7])
@pytest.mark.parametrize("n", range(1, 31))
def test_plan_covers_every_qubit_once_in_the_fewest_passes(n, group):
    f, groups = ops.layer_passes(n, group)
    widths = [f] + [w for _, w in groups]
    covered = list(range(f))
    for g0, w in groups:
        assert g0 == len(covered)  # contiguous, in order, above the fused pass
        covered += range(g0, g0 + w)
    assert covered == list(range(n))
    assert 1 <= f <= ops.FUSED_MAX_K and f >= min(n, group)
    assert all(1 <= w <= group for w in widths[1:])
    assert len(widths) == _fewest(n, group)
    split = [min(group, n - g0) for g0 in range(0, n, group)]  # the reference's
    if len(widths) == len(split):  # no pass to save
        assert widths == split
    f0, groups0 = ops.layer_passes(n, group, group)  # the split off the card
    assert [f0] + [w for _, w in groups0] == split


@pytest.mark.parametrize("n,group,want", [
    (26, 7, (12, 7, 7)),
    (24, 7, (10, 7, 7)),
    (20, 7, (7, 7, 6)),
    (12, 7, (12,)),
    (13, 3, (10, 3)),
])
def test_plan_widths(n, group, want):
    f, groups = ops.layer_passes(n, group)
    assert (f, *[w for _, w in groups]) == want


def _state(n, b, seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((b, 2**n))
    im = rng.standard_normal((b, 2**n))
    norm = np.sqrt((re**2 + im**2).sum(1, keepdims=True))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    return (t(re / norm), t(im / norm), t(rng.uniform(0, n, (b, 2**n))),
            t(rng.uniform(-2, 2, b)), t(rng.uniform(-2, 2, b)))


def test_plain_versions_along_the_plan_equal_the_reference_chain(monkeypatch):
    """n = 13, group = 3: the fused pass on qubits [0, 10) and one strided
    group [10, 13), each the plain version, forward and through the
    layer's backward (its adjoint passes, ∂β and ∂γ), against the phase
    and `ref.apply_mixer`'s chain of groups of 3 under autograd."""
    n, group = 13, 3
    monkeypatch.setattr(ops, "passes_on", lambda x, n, group: ops.layer_passes(n, group))
    re, im, cutv, gamma, beta = _state(n, 2, 5)
    d_re, d_im, _, _, _ = _state(n, 2, 6)

    def run(layer):
        args = [t.clone().requires_grad_(True) for t in (re, im, gamma, beta)]
        out = layer(*args)
        grads = torch.autograd.grad(out, args, (d_re, d_im))
        return [o.detach() for o in out], grads

    got, got_g = run(lambda r, i, g, b: ops.apply_layer(r, i, cutv, g, b, n, group))
    want, want_g = run(lambda r, i, g, b: ref.apply_mixer(
        *ref.apply_phase(r, i, cutv, g), n, b, group))
    # the planes, the cotangent planes, ∂γ and ∂β
    for x, y in zip([*got, *got_g], [*want, *want_g]):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
