"""The control of ``correct`` (the float64 reference computed at TF32, put
in the program's place) comes out not correct, and the program comes out
correct: on the CPU at the tiny size (the port's plain float32 path,
held to the tests' limits), and on the card at each cell's own size
against the cell's limits."""
import pytest

from portbench import control
from portbench.harness import check, common

from portbench_support import CHECK_LIMITS, TINY_SIZES


@pytest.mark.parametrize("name", ["j0005.single", "j0005.survey"])
def test_the_control_fails_where_the_program_passes_on_the_cpu(tiny_cell, name):
    cell = tiny_cell(name)
    limits = {k: v for k, v in CHECK_LIMITS.items() if k in cell.limits}
    got = control.readings(cell, 2**31 + 21, 1, "cpu", TINY_SIZES.get(name))
    assert check.judge(got["program"], limits)[0], got
    assert not check.judge(got["control"], limits)[0], got


@pytest.mark.card
@pytest.mark.parametrize("name", ["j0005.single", "j0005.survey"])
def test_the_control_fails_at_the_cells_size_on_the_card(card, name):
    cell = common.cell_for(name)
    got = control.readings(cell, 2**31 + 22, 1, "cuda")
    assert check.judge(got["program"], cell.limits)[0], got
    assert not check.judge(got["control"], cell.limits)[0], got
