"""The whole run, past the look for a chip, with the timed path broken
underneath (``faults.py``): ``correct`` comes out false for each fault a
search cell can have, and for the control. There is no exchange between
chips to leave out: both cells use one."""
import pytest

import faults

CELLS = ("sru_timit.search", "xlstm_350m.search")
CONTROL = {"sru_timit.search": "tf32", "xlstm_350m.search": "fp8"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_fails_the_check(cell, fault, small_run):
    with faults.planted(fault):
        res = small_run(cell, 7)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell, small_run):
    """The reference in the configuration's next lower precision in the
    program's place."""
    assert small_run(cell, 10, control=CONTROL[cell])["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes(cell, small_run):
    assert small_run(cell, 11)["correct"] is True
