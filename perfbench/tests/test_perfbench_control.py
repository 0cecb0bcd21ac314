"""The control fails the limits that the solver meets: the reference in
TF32 (float32 with its matrix products' inputs at a 10-bit mantissa) put in
the solver's place, on the rows the check draws, at a test's size. On the
CPU the TF32 rounding is made by hand; the card test makes it on the card,
where TF32 products are on as well. ``perfbench/control.py`` takes the
same readings at a cell's own size."""

import pytest
import torch

from perfbench.lib import bench, check, generate
from perfbench.tests import tiny

QAOA = ("qaoa_exp_err", "qaoa_prob_err")


def _readings(family, seed, device):
    from repro_torch.core.graph import Graph
    from repro_torch.core.paraqaoa import ParaQAOAConfig, solve

    sp = tiny.spec(family)
    inst = generate.instance(sp.traffic, seed, 0, device)
    res = solve(bench.graph_of(Graph, inst), ParaQAOAConfig(**sp.config), device=device)
    solved = [bench.solved_of(inst, res)]
    nums, plans = check.exact_numbers(sp.config, solved, device)
    q = check.qaoa_numbers(sp.config, solved, plans, seed, 1000, device, control=True)
    return sp.cell["limits"], nums, q


def _assert_control_fails(family, device):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        limits, nums, q = _readings(family, seed, device)
        assert all(nums[k] <= limits[k] for k in nums), nums
        assert all(q["solver"][k] <= limits[k] for k in QAOA), q
        assert any(q["control"][k] > limits[k] for k in QAOA), q


@pytest.mark.parametrize("family", ["er", "torus"])
def test_control_fails_where_the_solver_passes(family):
    _assert_control_fails(family, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["er", "torus"])
def test_control_fails_where_the_solver_passes_on_the_card(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solver's kernels and TF32 products")
    _assert_control_fails(family, "cuda")
