"""On the card: the control (the plain reference one precision below the
configuration's, in the program's place) fails the cell's limits, and the
program passes them, at sizes a test run holds. Skips without a
card. The cells' own control readings, at their own sizes, come from
python3 -m portbench.control."""

import pytest

from conftest import tiny_cell
from portbench import harness


@pytest.mark.card
@pytest.mark.parametrize("workload", ["r16k-features"])
def test_control_fails_and_program_passes(workload, card_device):
    cell = tiny_cell(workload)
    kind = harness.kind_module(cell)
    state = kind.setup(cell, 2**35 + 3, card_device)
    program = kind.answers(state, kind.program_outputs(state))
    control = kind.answers(state, kind.control_outputs(state))
    assert all(row[k] <= lim for row in program for k, lim in cell.limits.items())
    assert all(any(row[k] > lim for k, lim in cell.limits.items()) for row in control)
