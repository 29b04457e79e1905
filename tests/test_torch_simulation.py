"""The port's ``Simulation`` end to end against the JAX ``Simulation``.

``engine_backend="cuda"`` on CPU tensors (the kernels' plain versions) is
held against the reference's ``"pallas"`` (interpret mode), and ``"torch"``
against ``"xla"``, on a configuration where the reference adopts a new
mapping.  Exact: ``lb_steps``, the balancer events and mappings,
``history["efficiency"]`` (it is computed from the work counters) and
``dropped_total``.  The final particle state: alive masks exact, the
arrays ``z x ux uy uz w`` of the alive particles within 2e-5·max|ref| (as
fields are held), and their kinetic energy recomputed in float64 at rtol
1e-6.  Recorded histories: field energy rtol 1e-4
(``tests/test_kernel_backends.py``); float32 kinetic energy at
``test_torch_sharded.KE_RTOL`` (3e-3), twice the largest float32-vs-float64
gap measured on this laser-ion problem (``test_float32_kinetic_energy_gap_
within_tolerance`` there: the float32 sum of w·m·(γ-1) is quantised by
rounding of γ against 1 and differs by backend).
"""
import numpy as np
import pytest

from repro.pic import Simulation as JSimulation
from repro.pic import SimConfig as JSimConfig
from repro.pic import laser_ion_problem as j_laser_ion

from repro_torch.pic import Simulation, SimConfig, laser_ion_problem
from test_torch_sharded import FE_RTOL, KE64_RTOL, KE_RTOL, PARTICLE_KEYS, kinetic_energy_f64

PROBLEM = dict(nz=32, nx=32, box_cells=8, ppc=2)
LB = dict(n_virtual_devices=4, lb_interval=4)


def _events(sim):
    return [(e.step, e.adopted, e.boxes_moved) for e in sim.balancer.events]


@pytest.mark.parametrize("port,ref", [("cuda", "pallas"), ("torch", "xla")])
def test_simulation_matches_reference(port, ref):
    js = JSimulation(j_laser_ion(**PROBLEM), JSimConfig(engine_backend=ref, **LB))
    ts = Simulation(
        laser_ion_problem(**PROBLEM, device="cpu"),
        SimConfig(engine_backend=port, **LB),
        device="cpu",
    )
    js.run(8)
    ts.run(8)
    assert js.history["lb_steps"], "the configuration must make the reference adopt"
    assert ts.history["lb_steps"] == js.history["lb_steps"]
    assert _events(ts) == _events(js)
    np.testing.assert_array_equal(ts.balancer.mapping, js.balancer.mapping)
    assert ts.history["efficiency"] == js.history["efficiency"]
    assert ts.dropped_total == js.dropped_total == 0
    for key, rtol in (("field_energy", FE_RTOL), ("kinetic_energy", KE_RTOL)):
        np.testing.assert_allclose(
            ts.history[key], js.history[key], rtol=rtol, atol=1e-12, err_msg=key
        )
    assert_same_particles(ts.species, js.species)


def _alive_arrays(species):
    out = []
    for p in species:
        alive = np.asarray(p.alive, bool)
        out.append({k: np.asarray(getattr(p, k), np.float32)[alive] for k in PARTICLE_KEYS})
    return out


def assert_same_particles(port_species, ref_species):
    for p, r in zip(port_species, ref_species):
        np.testing.assert_array_equal(np.asarray(p.alive), np.asarray(r.alive))
    got, ref = _alive_arrays(port_species), _alive_arrays(ref_species)
    for s, (g, r) in enumerate(zip(got, ref)):
        for k in PARTICLE_KEYS:
            assert np.abs(g[k] - r[k]).max() <= 2e-5 * max(np.abs(r[k]).max(), 1e-30), (s, k)
    masses = [float(np.asarray(r.m)) for r in ref_species]
    np.testing.assert_allclose(
        kinetic_energy_f64(got, masses), kinetic_energy_f64(ref, masses), rtol=KE64_RTOL
    )


def test_work_counters_are_the_in_kernel_signal():
    """The fetched history's work rows equal box_work_counters summed over
    species (the counters are additive per species), and the per-species
    counts sum to the census."""
    import torch

    from repro_torch.pic.deposition import box_work_counters

    ts = Simulation(
        laser_ion_problem(**PROBLEM, device="cpu"), SimConfig(**LB), device="cpu"
    )
    ts.run(4)
    h = ts.last_outputs
    assert h.species_counts.shape == (4, 2, ts.grid.n_boxes)
    expect = sum(
        box_work_counters(torch.from_numpy(h.species_counts[:, s]), ts.grid).numpy()
        for s in range(2)
    )
    np.testing.assert_array_equal(h.work, expect)
    np.testing.assert_array_equal(h.counts, h.species_counts.sum(axis=1))


def test_bin_overflow_conserves_particles_and_counts_drops():
    kw = dict(nz=16, nx=16, box_cells=8, ppc=24, seed=0)
    jprob = j_laser_ion(**kw)
    js = JSimulation(jprob, JSimConfig(engine_backend="pallas", pallas_cap=256, lb_interval=4))
    js.run(4)
    prob = laser_ion_problem(**kw, device="cpu")
    alive0 = sum(int(p.alive.sum()) for p in prob.species)
    ts = Simulation(prob, SimConfig(kernel_cap=256, lb_interval=4), device="cpu")
    ts.run(4)
    assert sum(int(p.alive.sum()) for p in ts.species) == alive0
    assert ts.dropped_total > 0
    assert ts.dropped_total == js.dropped_total
    np.testing.assert_allclose(
        ts.history["field_energy"], js.history["field_energy"], rtol=1e-4, atol=1e-12
    )


def test_per_step_matches_fused():
    runs = []
    for fused in (True, False):
        sim = Simulation(
            laser_ion_problem(**PROBLEM, device="cpu"),
            SimConfig(fused=fused, **LB),
            device="cpu",
        )
        sim.run(6)
        runs.append(sim)
    a, b = runs
    assert a.history["lb_steps"] == b.history["lb_steps"]
    assert a.history["efficiency"] == b.history["efficiency"]
    assert _events(a) == _events(b)
    for key in ("field_energy", "kinetic_energy"):
        np.testing.assert_array_equal(a.history[key], b.history[key])


def test_device_defaults_to_cuda_without_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        laser_ion_problem(**PROBLEM)
    prob = laser_ion_problem(**PROBLEM, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(prob)
    with pytest.raises(ValueError, match="engine_backend"):
        Simulation(prob, SimConfig(engine_backend="pallas"), device="cpu")
    # every strategy of the reference is ported; an unknown one raises
    sim = Simulation(prob, SimConfig(cost_strategy="activity_ledger"), device="cpu")
    sim.run(1)
    assert sim.activity_rounds and sim.balancer.events
    with pytest.raises(ValueError, match="cost_strategy"):
        Simulation(prob, SimConfig(cost_strategy="cupti"), device="cpu")
