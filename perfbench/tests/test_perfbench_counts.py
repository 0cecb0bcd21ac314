"""The kernel counts give the bound column of PERF.md's kernel table at the
table's shapes (B = 18, n = 24), and the stage count its own arithmetic."""

import pytest

from perfbench.counts import qaoa_stage
from perfbench.lib import peaks
from perfbench.lib.counts import kernel_counts, owner

# table row → bound ms at (18, 2^24)
TABLE_MS = {"cutvals": 0.361, "fused_layer": 1.803, "mixer": 1.442, "expectation": 1.082,
            "mixer_trailing": 1.442, "apply_phase": 1.803, "beta_grad": 1.442,
            "phase_grad": 1.803}


@pytest.mark.parametrize("name", sorted(TABLE_MS))
def test_count_gives_the_tables_bound(name):
    mod = kernel_counts()[name]
    least = peaks.least_s(*mod.work(18, 24))
    assert round(least * 1e3, 3) == TABLE_MS[name]
    # bound by bytes at these shapes, as the table says
    ops, nbytes = mod.work(18, 24)
    assert nbytes / peaks.HBM_BYTES_PER_S >= ops / peaks.F32_FLOPS_PER_S


def test_every_count_names_its_launch_counter_and_kernels():
    counts = kernel_counts()
    assert set(counts) == set(TABLE_MS)
    for mod in counts.values():
        assert isinstance(mod.OP, str) and mod.KERNELS
    assert owner("fused_kernel<true>", counts).OP == "fused_phase_mixer_group"
    assert owner("fused_kernel<false>", counts).OP == "mixer_group_trailing"
    assert owner("beta_grad_kernel<12>", counts).OP == "beta_grad"
    assert owner("cutvals_fill<4>", counts).OP == "cutvals"
    assert owner("elementwise_kernel<128, 4>", counts) is None


def test_stage_count():
    ops, nbytes = qaoa_stage.work(18, 24, 3, 60)
    passes = 2 * 3 * 60 + 3
    assert nbytes == (1 + 4 * passes + 2) * 4 * 18 * 2**24
    # bound by bytes: 0.525 s a solve at the main path's shapes
    assert peaks.least_s(ops, nbytes) == pytest.approx(0.5247, abs=1e-4)
