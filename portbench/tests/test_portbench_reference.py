"""The plain reference against the program's CPU path at a small grid: a
sound run of every cell reads inside every limit."""
import pytest

from _cells import run_small

CELLS = ["laser_ion.sim", "uniform_plasma.sim", "laser_ion.sharded4"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run_small(workload)
    assert r["attempted"] == 20 and r["failed"] == 0
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert r["correct"]
    assert list(r)[-1] == "checks"
    assert {"step_ms", "peak_mem_gib", "setup_s"} == set(r["metrics"])
