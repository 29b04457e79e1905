"""The ``activity_ledger`` cost strategy of the port's ``Simulation``
against the reference's.

The strategy times the plain ``deposit_current`` once per (species, box)
with alive particles, so on a real clock its costs are wall times and
cannot match across packages.  With a stub clock that advances by exactly
1.0 per reading, injected into both ledgers (the port's through
``ActivityLedger.clock``, the reference's through the ``time`` its
``costs`` module reads), every record lasts 1.0 and a box's cost is the
number of species timed in it: then the records of each round (kernel,
box, start, end), the costs with their 0.1 floor, ``lb_steps``, the
balancer events and the mappings must all equal the reference's.  The rest
are the counterparts of ``tests/test_step_fusion.py:71`` and
``tests/test_pic_lb_integration.py:81``, and the clock hook itself.
"""
import types

import numpy as np
import pytest
import torch

import repro.core.costs as jcosts
from repro.pic import Simulation as JSimulation
from repro.pic import SimConfig as JSimConfig
from repro.pic import laser_ion_problem as j_laser_ion

from repro_torch.core import ActivityLedger
from repro_torch.pic import Simulation, SimConfig, laser_ion_problem

PROBLEM = dict(nz=32, nx=32, box_cells=8, ppc=2)
LB = dict(n_virtual_devices=4, lb_interval=4, cost_strategy="activity_ledger")


class Tick:
    """A clock that advances by exactly 1.0 per reading."""

    def __init__(self):
        self.t = -1.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _instrument(sim, rounds):
    """Log every round's delivered records and the costs it returned."""
    sim.ledger.register_callback(
        lambda batch: rounds.setdefault("records", []).extend(
            (r.name, r.box, r.start, r.end) for r in batch
        )
    )
    measure = sim._measure_activity_costs

    def wrapped(*args):
        costs = measure(*args)
        rounds.setdefault("costs", []).append(costs.copy())
        return costs

    sim._measure_activity_costs = wrapped


def _events(sim):
    return [(e.step, e.adopted, e.boxes_moved, e.current_efficiency, e.proposed_efficiency)
            for e in sim.balancer.events]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("port,ref", [("cuda", "pallas"), ("torch", "xla")])
def test_stub_clock_matches_reference(port, ref, fused, monkeypatch):
    monkeypatch.setattr(jcosts, "time", types.SimpleNamespace(perf_counter=Tick()))
    js = JSimulation(j_laser_ion(**PROBLEM), JSimConfig(engine_backend=ref, fused=fused, **LB))
    ts = Simulation(
        laser_ion_problem(**PROBLEM, device="cpu"),
        SimConfig(engine_backend=port, fused=fused, **LB),
        device="cpu",
    )
    ts.ledger.clock = Tick()
    ref_rounds, port_rounds = {}, {}
    _instrument(js, ref_rounds)
    _instrument(ts, port_rounds)
    js.run(8)
    ts.run(8)
    assert len(ref_rounds["costs"]) == 2  # rounds at steps 0 and 4
    assert port_rounds["records"] == ref_rounds["records"]
    assert all(end - start == 1.0 for _, _, start, end in port_rounds["records"])
    for got, want in zip(port_rounds["costs"], ref_rounds["costs"], strict=True):
        np.testing.assert_array_equal(got, want)
        # the floor: boxes with no record cost 0.1x the smallest timed box
        assert want.min() == 0.1 * want[want > want.min()].min()
    assert ts.history["lb_steps"] == js.history["lb_steps"]
    assert _events(ts) == _events(js)
    np.testing.assert_array_equal(ts.balancer.mapping, js.balancer.mapping)
    assert ts.history["efficiency"] == js.history["efficiency"]
    assert sum(r["records"] for r in ts.activity_rounds) == len(ref_rounds["records"])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_fused_splits_measurement_rounds(backend):
    """Counterpart of ``tests/test_step_fusion.py:71``: LB exactly at the
    round boundaries, finite trajectory, real per-box costs; the first
    step of each measurement round runs alone (one fetch for it)."""
    sim = Simulation(
        laser_ion_problem(nz=64, nx=64, box_cells=16, ppc=2, seed=3, device="cpu"),
        SimConfig(n_virtual_devices=4, lb_interval=5, cost_strategy="activity_ledger",
                  engine_backend=backend),
        device="cpu",
    )
    chunks = []
    run_chunk = sim._run_chunk
    sim._run_chunk = lambda n, p: (chunks.append(n), run_chunk(n, p))
    sim.run(10)
    assert chunks == [1, 4, 1, 4]
    assert sim.step_idx == 10
    assert len(sim.history["field_energy"]) == 10
    assert np.all(np.isfinite(sim.history["field_energy"]))
    assert [e.step for e in sim.balancer.events] == [0, 5]
    assert all(e.proposed_efficiency > 0 for e in sim.balancer.events)
    for rnd in sim.activity_rounds:
        assert rnd["records"] >= np.count_nonzero(rnd["box_s"] > 0) > 0
        assert np.all(rnd["box_s"] >= 0) and rnd["work"].shape == (sim.grid.n_boxes,)


def test_strategy_measures_costs():
    """Counterpart of ``tests/test_pic_lb_integration.py:81`` on its
    problem: usable costs, and the balancer ran on them."""
    sim = Simulation(
        laser_ion_problem(nz=128, nx=128, box_cells=16, ppc=4, seed=0, device="cpu"),
        SimConfig(n_virtual_devices=8, lb_interval=5, cost_strategy="activity_ledger"),
        device="cpu",
    )
    sim.run(6)
    assert sim.mean_efficiency > 0.0
    assert len(sim.balancer.events) >= 1
    rnd = sim.activity_rounds[0]
    occupied = int(np.count_nonzero(sim.last_outputs.counts[-1] > 0))
    assert rnd["records"] >= occupied > 0
    assert np.count_nonzero(rnd["box_s"]) <= rnd["records"]


def test_records_per_species_and_box():
    """Every (species, box) with alive particles is timed once per round,
    and nothing else: under the stub clock a box costs the number of
    species in it."""
    sim = Simulation(laser_ion_problem(**PROBLEM, device="cpu"), SimConfig(**LB), device="cpu")
    sim.ledger.clock = Tick()
    sim.run(1)
    want = np.zeros(sim.grid.n_boxes)
    for p in sim.species:
        ids = sim.grid.box_of_position(p.z, p.x)[p.alive].numpy()
        want[np.unique(ids)] += 1.0
    rnd = sim.activity_rounds[0]
    np.testing.assert_array_equal(rnd["box_s"], want)
    assert rnd["records"] == int(want.sum())


def test_ledger_clock_hook():
    ledger = ActivityLedger(clock=Tick())
    for b in (2, 0, 2):
        with ledger.timed("deposit", box=b):
            pass
    np.testing.assert_array_equal(ledger.box_durations(3, kernel="deposit"), [1.0, 0.0, 2.0])
    default = ActivityLedger()
    with default.timed("deposit", box=0):
        pass
    assert default.box_durations(1)[0] >= 0.0


def test_cuda_clock_is_chosen_on_a_gpu(monkeypatch):
    """On a CUDA device the ledger reads CUDA events; without one the
    default device raises instead of timing the CPU."""
    from repro_torch._device import CudaEventClock

    sim = Simulation(laser_ion_problem(**PROBLEM, device="cpu"), SimConfig(**LB), device="cpu")
    assert not isinstance(sim.ledger.clock, CudaEventClock)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(laser_ion_problem(**PROBLEM, device="cpu"), SimConfig(**LB))
