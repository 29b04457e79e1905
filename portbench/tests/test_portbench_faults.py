"""With the timed path broken underneath, the harness's run of a cell comes
out not correct: a state handed back unchanged, half of each species left
out, the exchange between logical devices left out, an answer altered where
it is made."""
import pytest

import _faults
from _cells import run_small

CASES = [
    ("laser_ion.sim", "stale_state"),
    ("uniform_plasma.sim", "stale_state"),
    ("laser_ion.sharded4", "stale_state"),
    ("laser_ion.sim", "half_batch"),
    ("uniform_plasma.sim", "half_batch"),
    ("laser_ion.sharded4", "half_batch"),
    ("laser_ion.sharded4", "no_exchange"),
    ("laser_ion.sim", "altered_answer"),
    ("uniform_plasma.sim", "altered_answer"),
    ("laser_ion.sharded4", "altered_answer"),
]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    with getattr(_faults, fault)():
        r = run_small(workload)
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    print(workload, fault, {k: c["value"] for k, c in r["checks"].items()})
    assert not r["correct"] and failed, r["checks"]
