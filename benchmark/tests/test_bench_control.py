"""On the card: the control (the plain reference computed in fp8 in the
program's place) comes out not correct at each cell's own size, and the
program comes out correct on the same seed.  Skips without as many cards
as the cell asks for."""
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.conftest import cells, spec

CELLS = cells()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = harness.Cell(name, spec())
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA card(s): the limits are the "
                    "cards'")
    out = calibrate.readings(cell, 2 ** 31 + 101, torch.device("cuda"),
                             2.0, control=True)
    limits = cell.limits

    def fails(reading):
        return any(reading[k][0] > lim if isinstance(reading[k], list)
                   else reading[k] > lim for k, lim in limits.items())
    assert fails(out["control"]), out["control"]
    assert not fails(out["program"]), out["program"]
