"""Each fault a cell can have turns ``correct`` false.

A whole run on the CPU at the tiny size (the harness's look for a card
skipped), with the timed path broken underneath (``portbench.faults``):
a sampler step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; half of the batch never stepped; an
answer altered where it is produced (one walker's lnpost).  The cells
run on one chip, so no exchange between chips can be left out.  The
limits are the tests' own, between the CPU path's sound readings and
the faults'."""
import pytest

from portbench import faults

from portbench_support import CHECK_LIMITS, TINY_SIZES


def _run(cell):
    from portbench import run

    limits = {k: v for k, v in CHECK_LIMITS.items() if k in cell.limits}
    return run.run_cell(cell, 2**31 + 9, 0.5, False, "cpu", sizes=TINY_SIZES.get(cell.name),
                        limits=limits)


@pytest.mark.parametrize("name", ["j0005.single", "j0005.survey"])
def test_the_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["j0005.single", "j0005.survey"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_is_not_correct(tiny_cell, name, fault):
    with faults.planted(fault):
        res = _run(tiny_cell(name))
    assert not res["correct"], res["checks"]
