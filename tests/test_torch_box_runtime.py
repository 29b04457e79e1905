"""The port's ``BoxRuntime`` against the reference's.

One device runs in process (the reference on its one CPU device); 2 and 4
devices run the reference once, in a subprocess started with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this file run as a
script writes its summaries of ``BOX_CASES`` to an ``.npz``), and the port
on logical CPU devices in process.  Both are driven by
``test_torch_sharded.drive``.  Exact: census per box, the balancer's events
and mappings, ``host_dispatches`` and the recovery events (wall times left
out); fields and the pooled final particles within 2e-5·max|ref|, their
float64 kinetic energy rtol 1e-6.  The cases: both pipelines at 2 and 4
devices with the balancer adopting on its own, a skewed-capacity adoption
that ``"async"`` lands one LB round after ``"sync"``, a forced adoption on
4 devices, a snapshot on 2 restored on 1, and ``RecoveryRunner`` with a
device killed at interval 2 on 2 devices (both pipelines) and on 4 (the
box runtime rebuilds on all 3 survivors).  The rest are the counterparts
of ``tests/test_dist_runtime.py:92-168`` and ``tests/test_distributed_
pic.py:62`` (at 4 logical devices).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_sharded as oracle

HERE = Path(__file__).resolve().parent
INTERVAL = 2


def _recover(n, pipeline, device):
    return ("laser", n, dict(lb_interval=INTERVAL, pipeline=pipeline),
            [("recover", dict(faults=[("kill_device", 2, dict(device=device))], steps=8))])


#: name -> (problem, n_devices, runtime kwargs, script), as MULTI_CASES
BOX_CASES = {}
for _n in (2, 4):
    for _pipe in ("sync", "async"):
        BOX_CASES[f"auto-{_n}-{_pipe}"] = (
            "laser", _n, dict(lb_interval=INTERVAL, pipeline=_pipe), [("run", 6)]
        )
for _pipe in ("sync", "async"):
    BOX_CASES[f"late-2-{_pipe}"] = (
        "laser", 2, dict(lb_interval=INTERVAL, pipeline=_pipe),
        [("capacities", [1.0, 0.25]), ("run", 1), ("run", 1), ("run", 2)],
    )
    BOX_CASES[f"recover-kill-2-{_pipe}"] = _recover(2, _pipe, 1)
BOX_CASES["forced-4"] = (
    "laser", 4, dict(lb_interval=INTERVAL, improvement_threshold=10.0),
    [("run", 2), ("force",), ("run", 2)],
)
BOX_CASES["restore-2-to-1"] = (
    "laser", 2, dict(lb_interval=INTERVAL), [("run", 4), ("restore", 1), ("run", 4)]
)
BOX_CASES["recover-kill-4-sync"] = _recover(4, "sync", 3)


def box_summary(rt, log=None) -> dict:
    f = rt.fields
    snap = rt.snapshot()
    masses = [float(np.asarray(p.m)) for p in rt.boxes[0]]
    caps = rt.balancer.capacities
    return {
        **{f"p{s}_{k}": np.asarray(sp[k], np.float32)
           for s, sp in enumerate(snap["species"]) for k in oracle.PARTICLE_KEYS},
        "ke64": np.float64(oracle.kinetic_energy_f64(snap["species"], masses)),
        "fields": np.stack([np.asarray(getattr(f, k)) for k in ("ex", "ey", "ez", "bx", "by", "bz")]),
        "box_counts": np.asarray(rt.box_counts()),
        "mapping": np.asarray(rt.balancer.mapping),
        "capacities": np.asarray([] if caps is None else caps, np.float64),
        "exact": np.asarray(oracle._json({
            "events": [(e.step, e.adopted, e.boxes_moved) for e in rt.balancer.events],
            "host_dispatches": rt.host_dispatches,
            "step_idx": rt.step_idx,
            "total_alive": rt.total_alive(),
            "devices_in_use": len(rt.devices_in_use()),
            **(log or {}),
        })),
    }


def assert_box_matches(port: dict, ref: dict) -> None:
    assert json.loads(str(port["exact"])) == json.loads(str(ref["exact"]))
    np.testing.assert_array_equal(port["box_counts"], ref["box_counts"])
    np.testing.assert_array_equal(port["mapping"], ref["mapping"])
    np.testing.assert_allclose(port["capacities"], ref["capacities"], rtol=1e-12)
    np.testing.assert_allclose(port["ke64"], ref["ke64"], rtol=oracle.KE64_RTOL, err_msg="ke64")
    for c in range(6):
        a, b = ref["fields"][c], port["fields"][c]
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), c
    keys = sorted(k for k in ref if k.startswith("p") and k[1].isdigit())
    assert keys and sorted(k for k in port if k.startswith("p") and k[1].isdigit()) == keys
    for key in keys:
        a, b = ref[key], port[key]
        assert a.shape == b.shape, key
        assert np.abs(a - b).max(initial=0.0) <= 2e-5 * max(np.abs(a).max(initial=0.0), 1e-30), key


def box_reference(spec) -> dict:
    """The reference's summary of ``spec`` (needs enough jax devices)."""
    import repro.dist as dist
    from repro.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return dist.BoxRuntime(oracle.problem(prob, laser_ion_problem, colliding_beams_problem),
                               n_devices=k, **kw)

    return box_summary(*oracle.drive(make, dist, n, script))


def box_port_run(spec):
    import repro_torch.dist as dist
    from repro_torch.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return dist.BoxRuntime(
            oracle.problem(prob, laser_ion_problem, colliding_beams_problem, device="cpu"), k,
            device="cpu", **kw,
        )

    return oracle.drive(make, dist, n, script)


def box_port(spec) -> dict:
    return box_summary(*box_port_run(spec))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("box_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"), str(HERE)])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_box_runtime.py"), str(out)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"
    data = np.load(out)
    return {
        name: {k.split("/", 1)[1]: data[k] for k in data.files if k.split("/", 1)[0] == name}
        for name in BOX_CASES
    }


def _check(name, reference):
    got = box_port(BOX_CASES[name])
    assert_box_matches(got, reference[name])
    return json.loads(str(got["exact"]))


@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("n", [2, 4])
def test_matches_reference(n, pipeline, reference):
    exact = _check(f"auto-{n}-{pipeline}", reference)
    assert exact["total_alive"] > 0


def test_some_case_adopts(reference):
    assert any(
        any(e[1] for e in json.loads(str(reference[f"auto-{n}-{p}"]["exact"]))["events"])
        for n in (2, 4) for p in ("sync", "async")
    )


def test_async_adoption_lands_one_round_after_sync(reference):
    """Skewed capacities force an adoption at step 0: sync places it at
    once; async keeps step 0's counters in flight and places the same
    mapping at the next LB round (the forced one, at step 1), recording it
    at its measurement step, as the reference does."""
    sync = _check("late-2-sync", reference)
    late = _check("late-2-async", reference)
    m0, m_sync, m_async = sync["mappings"][0], sync["mappings"], late["mappings"]
    assert m_sync[1] != m0
    assert m_async[1] == m0 and m_async[2] == m_sync[1]
    assert sync["events"][0][:2] == late["events"][0][:2] == [0, True]


def test_forced_adoption_on_four_matches_reference(reference):
    exact = _check("forced-4", reference)
    assert exact["devices_in_use"] == 4


def test_snapshot_on_two_restored_on_one_matches_reference(reference):
    exact = _check("restore-2-to-1", reference)
    assert exact["step_idx"] == 8 and exact["devices_in_use"] == 1


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_kill_on_two_recovers_as_reference(pipeline, reference):
    exact = _check(f"recover-kill-2-{pipeline}", reference)
    restores = [e for e in exact["recovery_events"] if e["kind"] == "restore"]
    assert len(restores) == 1 and restores[0]["ckpt_step"] == 2 * INTERVAL
    assert exact["n_devices_active"] == 1 and exact["step_idx"] == 8


def test_kill_on_four_rebuilds_on_three_as_reference(reference):
    """The box runtime has no equal-count constraint: all three survivors."""
    exact = _check("recover-kill-4-sync", reference)
    assert exact["n_devices_active"] == 3
    assert not any(e["kind"] == "degrade" for e in exact["recovery_events"])


# ---------------------------------------------------------------------------
# counterparts of tests/test_dist_runtime.py:92-168 and
# tests/test_distributed_pic.py:62
# ---------------------------------------------------------------------------


def _problem(**kw):
    from repro_torch.pic import laser_ion_problem

    return laser_ion_problem(**dict(oracle.PROBLEM, **kw), device="cpu")


def _box(n, **kw):
    from repro_torch.dist import BoxRuntime

    return BoxRuntime(_problem(), n, device="cpu", **kw)


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_matches_reference_single_device(pipeline):
    """The distributed step reproduces the reference's BoxRuntime on one
    device and the global solver's fields, and conserves particles."""
    from repro_torch.pic import SimConfig, Simulation
    from repro_torch.pic.fields import field_energy

    spec = ("laser", 1, dict(lb_interval=INTERVAL, pipeline=pipeline), [("run", 5)])
    rt, log = box_port_run(spec)
    assert_box_matches(box_summary(rt, log), box_reference(spec))
    n0 = sum(int(p.alive.sum()) for p in _problem().species)
    assert rt.total_alive() == n0 == rt.box_counts().sum()
    sim = Simulation(_problem(), SimConfig(lb_enabled=False, sponge_width=8,
                                           engine_backend="torch"), device="cpu")
    sim.run(5)
    assert float(field_energy(rt.fields, rt.grid)) == pytest.approx(
        sim.history["field_energy"][-1], rel=1e-4)
    f_rt = np.stack([c.numpy() for c in rt.fields])
    f_ref = np.stack([c.numpy() for c in sim.fields])
    assert np.abs(f_rt - f_ref).max() <= 1e-5 * max(np.abs(f_ref).max(), 1e-30)


def test_adoption_migration_preserves_state_on_2_devices():
    """Every reassigned box is re-placed on its new logical device, with
    particle count and dtypes kept, and the run goes on from there."""
    rt = _box(2, lb_interval=1000)
    n0 = rt.total_alive()
    before = rt.boxes[0][0]
    flipped = 1 - np.asarray(rt.balancer.mapping)
    d0 = rt.host_dispatches
    rt.apply_mapping(flipped)
    assert rt.host_dispatches - d0 == 3 * rt.grid.n_boxes  # tile, particles, statics per box
    for b in range(rt.grid.n_boxes):
        want = rt.devices[flipped[b]]
        assert rt.device_of(b) == want and rt.field_tiles[b].device == want
        for p in rt.boxes[b]:
            assert all(leaf.device == want for leaf in (p.z, p.x, p.ux, p.w, p.alive))
    after = rt.boxes[0][0]
    assert after.z.dtype == before.z.dtype == torch.float32
    assert after.alive.dtype == before.alive.dtype == torch.bool
    assert rt.total_alive() == n0
    rt.step()
    assert rt.total_alive() == n0
    assert rt.devices_in_use() == [0, 1]


def test_spreads_state_across_devices():
    rt = _box(2, lb_interval=2)
    assert rt.devices_in_use() == [0, 1]
    assert sorted(set(np.asarray(rt.balancer.mapping).tolist())) == [0, 1]


def test_four_devices_track_the_global_solver():
    """``tests/test_distributed_pic.py:62`` at 4 logical devices: particles
    conserved, state on all 4, the balancer adopts, the fields are the
    global solver's."""
    from repro_torch.pic import SimConfig, Simulation, laser_ion_problem

    kw = dict(nz=64, nx=64, box_cells=8, ppc=4, seed=0)
    rt = _box_on(laser_ion_problem(**kw, device="cpu"), 4)
    n0 = rt.total_alive()
    used = set()
    for _ in range(6):
        rt.step()
        used |= set(rt.devices_in_use())
    sim = Simulation(laser_ion_problem(**kw, device="cpu"),
                     SimConfig(lb_enabled=False, sponge_width=8, engine_backend="torch"),
                     device="cpu")
    sim.run(6)
    assert rt.total_alive() == n0 == rt.box_counts().sum()
    assert used == {0, 1, 2, 3}
    assert len(rt.balancer.events) >= 1 and any(e.adopted for e in rt.balancer.events)
    f_rt = np.stack([c.numpy() for c in rt.fields])
    f_ref = np.stack([c.numpy() for c in sim.fields])
    assert np.abs(f_rt - f_ref).max() <= 1e-5 * max(np.abs(f_ref).max(), 1e-30)


def _box_on(problem, n):
    from repro_torch.dist import BoxRuntime

    return BoxRuntime(problem, n, lb_interval=2, device="cpu")


def test_protocol_and_errors():
    from repro_torch.dist import BoxRuntime, DistributedPICRuntime

    rt = _box(2, lb_interval=2)
    assert isinstance(rt, DistributedPICRuntime)
    assert rt.n_slots() == rt.grid.n_boxes and rt.slot_costs() is None
    rt.run(2)
    assert rt.slot_costs() is not None
    rt.update_capacities(np.array([1.0, 0.5]))
    assert rt.balancer.should_run(rt.step_idx + 1)
    with pytest.raises(ValueError, match="valid device"):
        rt.apply_mapping(np.full(rt.grid.n_boxes, 2))
    with pytest.raises(ValueError, match="halo"):
        BoxRuntime(_problem(), 1, halo=3, device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        BoxRuntime(_problem(), 1, pipeline="eager", device="cpu")
    with pytest.raises(ValueError, match="tiles"):
        rt.restore(dict(rt.snapshot(), tiles=np.zeros((1, 6, 8, 8), np.float32)))


def test_default_device_is_cuda(monkeypatch):
    from repro_torch.dist import BoxRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        BoxRuntime(_problem(), 2)


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    out = {}
    for name, spec in BOX_CASES.items():
        for key, val in box_reference(spec).items():
            out[f"{name}/{key}"] = val
    np.savez(sys.argv[1], **out)
