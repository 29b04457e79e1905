"""The control (the reference in bfloat16 in the program's place) comes out
not correct: at the small size on the CPU, and at each cell's own size on
the card (three seeds)."""
import pytest

from _small import CONFIG, SEED
from portbench import control, spec

CELLS = ["laser_ion.sim", "uniform_plasma.sim", "laser_ion.sharded4"]


def _fails(cell, nums):
    # the control keeps no LB rounds or work rows: their checks do not apply
    return [k for k, lim in cell.limits.items() if nums.get(k, 0.0) > lim]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_small(workload):
    cell = spec.load(workload)
    cell.traffic = dict(cell.traffic, stretch_intervals=2)
    nums = control.readings(cell, SEED, device="cpu", config_overrides=CONFIG)
    print(workload, nums)
    assert _fails(cell, nums), nums


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_at_cell_size(card, workload, seed):
    cell = spec.load(workload)
    nums = control.readings(cell, seed, device=card)
    print(workload, seed, nums)
    assert _fails(cell, nums), nums
