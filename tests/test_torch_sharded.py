"""The port's ``ShardedRuntime`` on one device against the reference's, in
process (the reference runs on its one CPU device).

Port ``"torch"`` is held to reference ``"xla"`` with the balancer left to
itself (both feed it ``box_work_counters`` of the alive counts); port
``"cuda"`` (the kernels' plain versions on CPU tensors) with
``improvement_threshold=10.0``, as the reference's own backend oracle does,
since its work signal is the in-kernel counters.  Census, drops, LB steps,
fetch and dispatch counts, ``comm_stats()`` and ``migration_stats()`` are
exact; fields and the final particle arrays within 2e-5·max|ref|; the
float64 kinetic energy of the final particles rtol 1e-6; the recorded
float32 energy histories within ``FE_RTOL`` and ``KE_RTOL``
(``assert_matches`` below).  The multi-device cases are in
``test_torch_sharded_multi.py``.

Why the float32 kinetic-energy history gets its own tolerance: on the
laser-ion test problem Σ w·m·γ ≈ 773 while Σ w·m·(γ-1) ≈ 6e-4, so float32
``sqrt(1+u²) - 1`` is quantised to ulps of 1 and its rounding depends on
how the backend evaluates the expression (torch's CPU kernels, XLA and
numpy disagree on a share of the elements).  Both particle states carry the
same energy to ~1e-8 in float64; the recorded float32 sums do not.
``test_float32_kinetic_energy_gap_within_tolerance`` measures the gap of
each float32 evaluation (XLA, torch, numpy, and the recorded history)
against float64 on the test problems, step by step over 12 steps: at most
1.48e-3 (laser-ion at step 12; 3e-4 over the first four steps; beams
below 1e-6), so ``KE_RTOL`` is twice that, 3e-3.

The module also holds what both test files share: the same scripted run
(``drive``) is applied to either runtime on bit-identical problems and
``summary`` reduces it to numpy arrays and JSON strings, which
``assert_matches`` compares.  Run as a script it writes the reference's
summaries of ``MULTI_CASES`` to an ``.npz``; the multi-device test starts
it in a fresh interpreter with ``XLA_FLAGS=--xla_force_host_platform_
device_count=4``, as ``tests/test_distributed_pic.py`` does.
"""
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.dist import (
    DistributedPICRuntime,
    ShardedRuntime,
    StragglerDetector,
    validate_pipeline,
)
from repro_torch.kernels.constants import DEPOSIT_TILE
from repro_torch.pic import laser_ion_problem

# The suite runs several pytest workers on one machine, and these tests
# issue many small tensor ops: with torch's default of one intra-op thread
# per core in every worker, the workers' thread pools oversubscribe the
# cores and small ops slow down by orders of magnitude.  Every worker
# imports this module (the port's tests share it), so one thread each.
torch.set_num_threads(1)

PROBLEM = dict(nz=32, nx=32, box_cells=8, ppc=2)
BEAMS = dict(nz=32, nx=32, box_cells=8, ppc=4)


def _forced(mapping, n):
    """The forced adoption: every box to the next device on the ring
    (equal counts kept)."""
    return (np.asarray(mapping) + 1) % n


#: name -> (problem, n_devices, runtime kwargs, script); a script is a list
#: of ("run", steps) / ("force",) / ("straggle",) / ("restore", n) /
#: ("capacities", values) / ("recover", spec) actions (see ``drive``)
MULTI_CASES = {}
for _n in (2, 4):
    for _comm in ("neighbor", "ring"):
        # the balancer left to adopt on its own (same work signal as "xla")
        MULTI_CASES[f"auto-{_n}-{_comm}"] = (
            "laser", _n, dict(comm=_comm, lb_interval=4), [("run", 12)]
        )
        # no autonomous adoption, one forced adoption half way
        MULTI_CASES[f"forced-{_n}-{_comm}"] = (
            "laser", _n, dict(comm=_comm, lb_interval=4, improvement_threshold=10.0),
            [("run", 4), ("force",), ("run", 4)],
        )
MULTI_CASES["straggler-4-neighbor"] = (
    "laser", 4, dict(lb_interval=4), [("straggle",), ("run", 12)]
)
MULTI_CASES["restore-2-to-1"] = (
    "laser", 2, dict(lb_interval=4), [("run", 4), ("restore", 1), ("run", 4)]
)
for _n in (2, 4):
    for _comm in ("neighbor", "ring"):
        # the async pipeline, the balancer adopting on its own
        MULTI_CASES[f"async-{_n}-{_comm}"] = (
            "laser", _n, dict(comm=_comm, lb_interval=4, pipeline="async"), [("run", 12)]
        )
# skewed capacities force an adoption at step 0; async lands it one
# interval after sync (stopping after each interval, as the staleness
# test in test_torch_pipeline.py does)
for _pipe in ("sync", "async"):
    MULTI_CASES[f"late-2-{_pipe}"] = (
        "laser", 2, dict(lb_interval=2, pipeline=_pipe),
        [("capacities", [1.0, 0.25]), ("run", 2), ("run", 2), ("run", 2)],
    )
# RecoveryRunner over the sharded runtime under seeded fault schedules
# (8 steps of lb_interval 2, checkpoints every interval)
for _pipe in ("sync", "async"):
    MULTI_CASES[f"recover-kill-2-{_pipe}"] = (
        "laser", 2, dict(lb_interval=2, pipeline=_pipe),
        [("recover", dict(faults=[("kill_device", 2, dict(device=1))], steps=8))],
    )
# 16 boxes do not split over 3 survivors: the rebuild degrades to 2
MULTI_CASES["recover-kill-4-async"] = (
    "laser", 4, dict(lb_interval=2, pipeline="async"),
    [("recover", dict(faults=[("kill_device", 2, dict(device=3))], steps=8))],
)
# a fault re-firing on every replay climbs the ladder: retry, tighter
# packs, one device fewer.  These two run under "sync": the reference's
# async runtime cannot restore in place after a corrupt-state fault (its
# restore harvests the round in flight into the poisoned balancer and
# raises), so the port's async runs of them are held to these events
MULTI_CASES["recover-ladder-2"] = (
    "laser", 2, dict(lb_interval=2),
    [("recover", dict(faults=[("nan_history", 1, dict(repeats=3))], steps=8,
                      runner=dict(max_retries=1, backoff_s=0.001)))],
)
# a seeded draw: corruption at intervals 0 and 2, a torn write at 3
MULTI_CASES["recover-seeded-2"] = (
    "laser", 2, dict(lb_interval=2),
    [("recover", dict(seeded=dict(seed=3, n_intervals=4, rate=0.6,
                                  kinds=("nan_history", "torn_ckpt", "worker_exc"), n_devices=2),
                      steps=8))],
)


# split-phase stepping through an adoption (the gate open, and one forced)
for _n in (2, 4):
    for _comm in ("neighbor", "ring"):
        MULTI_CASES[f"overlap-{_n}-{_comm}"] = (
            "split", _n, dict(comm=_comm, lb_interval=3, overlap=True, improvement_threshold=0.0),
            [("run", 3), ("force",), ("run", 6)],
        )


#: 16-cell boxes keep an interior band under halo 4 (8-cell boxes are all
#: frontier), so split-phase stepping has something to split
SPLIT = dict(nz=32, nx=32, box_cells=16, ppc=3)


def problem(name, laser_ion, beams, **kw):
    if name == "split":
        return laser_ion(**SPLIT, **kw)
    return (laser_ion(**PROBLEM, **kw) if name == "laser" else beams(**BEAMS, **kw))


#: wall-clock fields of RecoveryRunner events (left out of comparisons)
WALL_KEYS = ("wall_s", "snapshot_s", "detect_s", "restore_s")


def recovery_log(runner, ckpt_dir) -> dict:
    """A RecoveryRunner's events without wall times, and the steps on disk."""
    from pathlib import Path

    return {
        "recovery_events": [
            {k: v for k, v in e.items() if k not in WALL_KEYS} for e in runner.events
        ],
        "ckpt_steps": sorted(
            int(p.name[5:]) for p in Path(ckpt_dir).glob("step_*") if (p / "manifest.json").exists()
        ),
        "n_devices_active": runner.n_devices_active,
    }


def drive(make, dist, n, script):
    """Apply ``script`` to ``make(n)`` with the runtime package ``dist``
    (``repro.dist`` or ``repro_torch.dist``); returns the runtime at the
    end and a log: the mapping before the script and after each run, and
    the recovery runner's events when the script has one."""
    import shutil
    import tempfile
    import warnings

    rt = make(n)
    log = {"mappings": [np.asarray(rt.balancer.mapping).tolist()]}
    for action in script:
        if action[0] == "run":
            rt.run(action[1])
            log["mappings"].append(np.asarray(rt.balancer.mapping).tolist())
        elif action[0] == "force":
            rt.apply_mapping(_forced(rt.balancer.mapping, n))
        elif action[0] == "straggle":
            # the last device is four times slower than the others
            times = np.ones(n)
            times[-1] = 4.0
            rt.attach_straggler_detector(dist.StragglerDetector(n, alpha=1.0),
                                         time_fn=lambda r, e: times)
        elif action[0] == "restore":
            snap = rt.snapshot()
            rt = make(action[1])
            rt.restore(snap)
        elif action[0] == "capacities":
            rt.update_capacities(np.asarray(action[1], np.float64))
        elif action[0] == "recover":
            spec = action[1]
            faults = [dist.Fault(kind, interval=k, **kw) for kind, k, kw in spec.get("faults", ())]
            schedule = dist.FaultSchedule(faults, **spec.get("seeded", {}))
            ckpt_dir = tempfile.mkdtemp(prefix="recovery_")
            try:
                runner = dist.RecoveryRunner(make, n, ckpt_dir=ckpt_dir,
                                             injector=dist.FaultInjector(schedule),
                                             **spec.get("runner", {}))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # torn and failed writes warn
                    runner.run(spec["steps"])
                rt = runner.runtime
                log.update(recovery_log(runner, ckpt_dir))
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
    return rt, log


def _json(obj) -> str:
    def plain(o):
        if isinstance(o, dict):
            return {str(k): plain(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [plain(v) for v in o]
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        return o

    return json.dumps(plain(obj), sort_keys=True)


#: rtol of the recorded float32 field-energy histories (the reference's)
FE_RTOL = 1e-4
#: rtol of the recorded float32 kinetic-energy histories: twice the largest
#: float32-vs-float64 gap measured on the test problems (module docstring)
KE_RTOL = 3e-3
#: rtol of the kinetic energy recomputed in float64 from the final particles
KE64_RTOL = 1e-6
#: the particle arrays a snapshot pools per species
PARTICLE_KEYS = ("z", "x", "ux", "uy", "uz", "w")


def kinetic_energy_f64(species, masses) -> float:
    """Σ w·m·(γ-1) in float64 over per-species dicts (or NamedTuples) of
    alive particles; γ-1 is evaluated as u²/(1+γ), free of cancellation."""
    total = 0.0
    for sp, m in zip(species, masses):
        get = sp.__getitem__ if isinstance(sp, dict) else lambda k, sp=sp: getattr(sp, k)
        w, ux, uy, uz = (np.asarray(get(k), np.float64) for k in ("w", "ux", "uy", "uz"))
        u2 = ux**2 + uy**2 + uz**2
        total += float(np.sum(w * float(m) * (u2 / (1.0 + np.sqrt(1.0 + u2)))))
    return total


def summary(rt, log=None) -> dict:
    f = rt.fields
    caps = rt.balancer.capacities
    snap = rt.snapshot()
    particles = {
        f"p{s}_{k}": np.asarray(sp[k], np.float32)
        for s, sp in enumerate(snap["species"])
        for k in PARTICLE_KEYS
    }
    return {
        **particles,
        "ke64": np.float64(kinetic_energy_f64(snap["species"], [m for _, m in rt._qm])),
        "fields": np.stack([np.asarray(getattr(f, k)) for k in ("ex", "ey", "ez", "bx", "by", "bz")]),
        "field_energy": np.asarray(rt.history["field_energy"], np.float64),
        "kinetic_energy": np.asarray(rt.history["kinetic_energy"], np.float64),
        "box_counts": np.asarray(rt.box_counts()),
        "mapping": np.asarray(rt.balancer.mapping),
        "capacities": np.asarray([] if caps is None else caps, np.float64),
        "exact": np.asarray(
            _json(
                {
                    "dropped_total": rt.dropped_total,
                    "lb_steps": rt.history["lb_steps"],
                    "host_syncs": rt.host_syncs,
                    "host_dispatches": rt.host_dispatches,
                    "comm_stats": rt.comm_stats(),
                    "migration_stats": rt.migration_stats(),
                    "hop_radius": rt.hop_radius(),
                    "events": [(e.step, e.adopted, e.boxes_moved) for e in rt.balancer.events],
                    "step_idx": rt.step_idx,
                    "pipeline": rt.pipeline_stats()["pipeline"],
                    **(log or {}),
                }
            )
        ),
    }


def assert_matches(port: dict, ref: dict) -> None:
    assert json.loads(str(port["exact"])) == json.loads(str(ref["exact"]))
    np.testing.assert_array_equal(port["box_counts"], ref["box_counts"])
    np.testing.assert_array_equal(port["mapping"], ref["mapping"])
    np.testing.assert_allclose(port["capacities"], ref["capacities"], rtol=1e-12)
    for key, rtol in (("field_energy", FE_RTOL), ("kinetic_energy", KE_RTOL)):
        np.testing.assert_allclose(port[key], ref[key], rtol=rtol, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(port["ke64"], ref["ke64"], rtol=KE64_RTOL, err_msg="ke64")
    for c in range(6):
        a, b = ref["fields"][c], port["fields"][c]
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), c
    keys = sorted(k for k in ref if k.startswith("p") and k[1].isdigit())
    assert keys and sorted(k for k in port if k.startswith("p") and k[1].isdigit()) == keys
    for key in keys:
        a, b = ref[key], port[key]
        assert a.shape == b.shape, key
        assert np.abs(a - b).max(initial=0.0) <= 2e-5 * max(np.abs(a).max(initial=0.0), 1e-30), key


def reference(spec) -> dict:
    """The reference's summary of ``spec`` (needs enough jax devices)."""
    import repro.dist as dist
    from repro.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return dist.ShardedRuntime(problem(prob, laser_ion_problem, colliding_beams_problem), k,
                                   engine_backend="xla", **kw)

    return summary(*drive(make, dist, n, script))


def port_run(spec, engine_backend: str):
    """The port's runtime at the end of ``spec``, on logical CPU devices,
    and its log (see ``drive``)."""
    import repro_torch.dist as dist
    from repro_torch.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return dist.ShardedRuntime(
            problem(prob, laser_ion_problem, colliding_beams_problem, device="cpu"), k,
            engine_backend=engine_backend, device="cpu", **kw,
        )

    return drive(make, dist, n, script)


def port(spec, engine_backend: str) -> dict:
    """The port's summary of ``spec`` on logical CPU devices."""
    return summary(*port_run(spec, engine_backend))



def _spec(comm, backend, script=(("run", 8),), prob="laser", **kw):
    kw.setdefault("lb_interval", 4)
    if backend == "cuda":
        kw.setdefault("improvement_threshold", 10.0)
    return (prob, 1, dict(comm=comm, **kw), list(script))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_single_device_matches_reference(comm, backend):
    spec = _spec(comm, backend)
    assert_matches(port(spec, backend), reference(spec))


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_unaligned_run_lengths_match_reference(comm):
    """Runs that end mid-interval split into the reference's pieces: the
    same fetch count, LB steps and physics."""
    spec = _spec(comm, "torch", script=(("run", 3), ("run", 6)))
    got, ref = port(spec, "torch"), reference(spec)
    assert_matches(got, ref)
    # pieces 2, 1 | 1, 4, 1: one fetch each
    assert json.loads(str(got["exact"]))["host_syncs"] == 5


@pytest.mark.parametrize("adaptive", [False, True])
def test_pack_overflow_matches_reference(adaptive):
    """Fast counter-streaming beams overflow packs of 16: the drops are
    counted exactly as the reference counts them (and with the adaptive
    controller, the packs grow as the reference's do)."""
    spec = _spec("neighbor", "torch", prob="beams", mig_cap=16, adaptive_mig=adaptive)
    got, ref = port(spec, "torch"), reference(spec)
    assert_matches(got, ref)
    exact = json.loads(str(got["exact"]))
    assert exact["dropped_total"] > 0
    assert (exact["migration_stats"]["resizes"] > 0) == adaptive


def test_state_check_catches_a_momentum_error():
    """The float64 check sees an error the float32 histories cannot: the
    electrons' momenta scaled by 1+1e-5 after an exact run fail it."""
    spec = _spec("neighbor", "torch")
    ref = reference(spec)
    rt, log = port_run(spec, "torch")
    assert_matches(summary(rt, log), ref)
    for per_device in rt._species:
        for k in ("ux", "uy", "uz"):
            per_device[0][k].mul_(1.0 + 1e-5)
    with pytest.raises(AssertionError, match="ke64"):
        assert_matches(summary(rt, log), ref)


def float32_kinetic_energies(species, masses):
    """Σ w·m·(γ-1) evaluated in float32 by numpy, torch and XLA."""
    import jax.numpy as jnp

    out = {"numpy": 0.0, "torch": 0.0, "xla": 0.0}
    for sp, m in zip(species, masses):
        w, ux, uy, uz = (np.asarray(sp[k], np.float32) for k in ("w", "ux", "uy", "uz"))
        m32 = np.float32(m)
        e = w * m32 * (np.sqrt(np.float32(1) + ux**2 + uy**2 + uz**2) - np.float32(1))
        out["numpy"] += float(e.sum(dtype=np.float32))
        t = [torch.from_numpy(a) for a in (w, ux, uy, uz)]
        out["torch"] += float((t[0] * m * (torch.sqrt(1.0 + t[1] ** 2 + t[2] ** 2 + t[3] ** 2) - 1.0)).sum())
        j = [jnp.asarray(a) for a in (w, ux, uy, uz)]
        out["xla"] += float((j[0] * m32 * (jnp.sqrt(1.0 + j[1] ** 2 + j[2] ** 2 + j[3] ** 2) - 1.0)).sum())
    return out


def test_float32_kinetic_energy_gap_within_tolerance():
    """The measurement behind ``KE_RTOL``: the reference runs each test
    problem 12 steps, one at a time; after each step the kinetic energy of
    its particles is evaluated in float32 by numpy, torch and XLA and read
    from its recorded history, and each is compared with the float64 value.
    Measured: at most 1.48e-3 (laser-ion, step 12), above the old 1e-4, and
    ``KE_RTOL`` is twice it.  Both sides' float64 energies agree to ~1e-8."""
    from repro.dist.sharded_runtime import ShardedRuntime as JShardedRuntime
    from repro.pic import colliding_beams_problem, laser_ion_problem

    worst = 0.0
    for name in ("laser", "beams"):
        rt = JShardedRuntime(problem(name, laser_ion_problem, colliding_beams_problem), 1,
                             lb_interval=4, engine_backend="xla")
        masses = [m for _, m in rt._qm]
        for _ in range(12):
            rt.run(1)
            snap = rt.snapshot()
            ke64 = kinetic_energy_f64(snap["species"], masses)
            evals = float32_kinetic_energies(snap["species"], masses)
            evals["history"] = rt.history["kinetic_energy"][-1]
            worst = max(worst, max(abs(v - ke64) / ke64 for v in evals.values()))
    assert 1e-4 < worst and 2 * worst <= KE_RTOL, worst


def _cpu_problem(**kw):
    return laser_ion_problem(**dict(PROBLEM, **kw), device="cpu")


def test_indivisible_box_count_raises():
    with pytest.raises(ValueError, match="evenly"):
        ShardedRuntime(_cpu_problem(), 3, device="cpu")


def test_bad_mappings_raise():
    rt = ShardedRuntime(_cpu_problem(), 2, device="cpu")
    n = rt.grid.n_boxes
    with pytest.raises(ValueError, match="valid device"):
        rt.apply_mapping(np.zeros(n - 1, np.int64))
    with pytest.raises(ValueError, match="valid device"):
        rt.apply_mapping(np.full(n, 2))
    with pytest.raises(ValueError, match="exactly"):
        rt.apply_mapping(np.r_[np.zeros(n // 2 + 1), np.ones(n // 2 - 1)].astype(np.int64))


def test_flags_not_ported_raise():
    assert validate_pipeline("async") == "async"
    # split-phase stepping is ported for the plain path; the kernels'
    # path raises, as the reference's "pallas" does
    assert ShardedRuntime(_cpu_problem(), 1, device="cpu", overlap=True,
                          engine_backend="torch").overlap
    with pytest.raises(ValueError, match="overlap"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", overlap=True)
    with pytest.raises(ValueError, match="pipeline"):
        validate_pipeline("eager")
    with pytest.raises(ValueError, match="engine_backend"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", engine_backend="xla")
    with pytest.raises(ValueError, match="shape_order"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", shape_order=1)
    with pytest.raises(ValueError, match="comm"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", comm="tree")
    with pytest.raises(ValueError, match="halo"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", halo=3)


def test_default_device_is_cuda(monkeypatch):
    """Without ``device=`` the logical devices are CUDA, which raises
    without a GPU instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedRuntime(_cpu_problem(), 4)


def test_protocol_and_capacities():
    rt = ShardedRuntime(_cpu_problem(), 2, device="cpu", lb_interval=4)
    assert isinstance(rt, DistributedPICRuntime)
    assert rt.n_slots() == rt.grid.n_boxes and rt.slot_costs() is None
    assert all(c % DEPOSIT_TILE == 0 for c in rt._caps)  # the kernels' chunk
    assert rt.devices_in_use() == [0, 1]
    rt.run(4)
    assert rt.slot_costs() is not None and (rt.slot_costs() > 0).all()
    rt.update_capacities(np.array([1.0, 0.5]))
    assert rt.balancer.should_run(rt.step_idx + 1)  # forced next round
    assert rt.total_alive() == int(rt.box_counts().sum()) > 0
    info = rt.step()
    assert info["step"] == 5 and info["alive"] == rt.total_alive()


def test_snapshot_restores_on_fewer_devices():
    """A snapshot is box-major and device-count independent: taken on two
    logical devices and restored on one, the run goes on with the same
    physics as the original."""
    a = ShardedRuntime(_cpu_problem(), 2, device="cpu", lb_interval=4, engine_backend="torch")
    a.run(4)
    snap = a.snapshot()
    assert snap["tiles"].shape == (a.grid.n_boxes, 6, a.grid.box_nz, a.grid.box_nx)
    b = ShardedRuntime(_cpu_problem(), 1, device="cpu", lb_interval=4, engine_backend="torch")
    b.restore(snap)
    for k in ("ex", "ey", "ez", "bx", "by", "bz"):
        assert torch.equal(getattr(b.fields, k), getattr(a.fields, k)), k
    assert b.total_alive() == a.total_alive() and b.step_idx == 4
    a.run(4)
    b.run(4)
    np.testing.assert_allclose(
        b.history["field_energy"], a.history["field_energy"][4:], rtol=1e-5
    )
    assert b.total_alive() == a.total_alive()
    np.testing.assert_array_equal(b.box_counts(), a.box_counts())


def test_straggler_detector_matches_reference():
    from repro.dist.straggler import StragglerDetector as JDetector

    rng = np.random.default_rng(3)
    a, b = JDetector(4, alpha=0.5), StragglerDetector(4, alpha=0.5)
    for _ in range(5):
        work, times = rng.uniform(1, 2, 4), rng.uniform(0.5, 3, 4)
        np.testing.assert_array_equal(b.update(work, times), a.update(work, times))
        assert b.stragglers() == a.stragglers()


if __name__ == "__main__":
    out = {}
    for name, spec in MULTI_CASES.items():
        for key, val in reference(spec).items():
            out[f"{name}/{key}"] = val
    np.savez(sys.argv[1], **out)
