"""portbench/bounds.py reproduces the bound ms of PERF.md's kernel table
(rows 1, 4, 4g and 3h, 125 walkers, 2 Sersics and a point source)."""
import pytest

from portbench import bounds


@pytest.mark.parametrize("row, work, want_ms", [
    ("1: render, 128x128", lambda: bounds.render_work(125, 128, 128, 2), 0.00294),
    ("4: conv_lnl, 128x128", lambda: bounds.conv_lnl_work(125, 128, 128), 0.00480),
    ("4g: conv_lnl, 512x512", lambda: bounds.conv_lnl_work(125, 512, 512), 0.0964),
    ("3h: fused_lnl, 512x512", lambda: bounds.fused_lnl_work(125, 512, 512, 2, 1), 0.128),
    ("3: fused_lnl, 128x128", lambda: bounds.fused_lnl_work(125, 128, 128, 2, 1), 0.00679),
])
def test_bound_ms_matches_the_kernel_table(row, work, want_ms):
    got = bounds.bound_ms(*work())
    assert got == pytest.approx(want_ms, rel=0.006), row


def test_the_bound_is_the_largest_term():
    nbytes, ops = bounds.conv_lnl_work(125, 128, 128)
    assert bounds.bound_ms(nbytes, ops) == pytest.approx(ops / bounds.FP32_FLOP_PER_S * 1e3)
    assert bounds.bound_ms(10 * nbytes, 0) == pytest.approx(10 * nbytes / bounds.HBM_BYTES_PER_S * 1e3)


def test_the_target_axis_reads_each_targets_planes():
    one, _ = bounds.conv_lnl_work(1216, 128, 128, targets=1)
    many, _ = bounds.conv_lnl_work(1216, 128, 128, targets=64)
    assert many - one == 63 * 3 * 4 * 128 * 128
