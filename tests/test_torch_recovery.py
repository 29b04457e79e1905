"""The port's recovery layer (``RecoveryRunner``, ``faults``, ``elastic``)
over its ``ShardedRuntime`` against the reference's, on one device in
process (the 2- and 4-device cases are in ``test_torch_sharded_multi.py``).

Each chaos case runs the same seeded ``FaultSchedule`` through both
packages (8 steps, ``lb_interval=2``, a checkpoint every interval):
``RecoveryRunner.events`` without their wall times, the steps left on disk
and the final physics (``test_torch_sharded.assert_matches``) agree.  Under
``pipeline="async"`` the port is held to the reference's sync run, since
the reference's async runtime cannot restore in place after a
corrupt-state fault (its restore harvests the round in flight into the
poisoned balancer); the recovery events do not depend on the pipeline.
The rest are counterparts of ``tests/test_recovery.py``'s sharded cases,
then of its ``kind="box"`` cases over the port's ``BoxRuntime`` (one device
here, against the reference's in process; the kills on 2 and 4 devices are
in ``test_torch_box_runtime.py``).
"""
import json

import numpy as np
import pytest

import test_torch_sharded as oracle
from repro_torch.ckpt import CheckpointManager, available_steps
from repro_torch.dist import (
    ElasticRunner,
    Fault,
    FaultInjector,
    FaultSchedule,
    RecoveryError,
    RecoveryRunner,
    ShardedRuntime,
)
from repro_torch.pic import laser_ion_problem

INTERVAL = 2
STEPS = 8

#: name -> fault list of the chaos cases held to the reference
CHAOS = {
    "nan_history": [("nan_history", 1, {})],
    "torn_ckpt": [("torn_ckpt", 2, {}), ("nan_history", 2, {})],
    "worker_exc": [("worker_exc", 1, {})],
    "nan_twice": [("nan_history", 1, dict(repeats=2))],
}


def _spec(pipeline, faults, **runner):
    return ("laser", 1, dict(lb_interval=INTERVAL, pipeline=pipeline),
            [("recover", dict(faults=faults, steps=STEPS, runner=runner))])


def _exact(summary):
    return json.loads(str(summary["exact"]))


@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("case", sorted(CHAOS))
def test_chaos_matches_reference(case, pipeline):
    ref = oracle.reference(_spec("sync", CHAOS[case]))
    got = oracle.port(_spec(pipeline, CHAOS[case]), "torch")
    if pipeline == "sync":
        oracle.assert_matches(got, ref)
    else:
        # one device: the pipeline moves no particle, so all but the LB
        # timing (lb_steps, syncs, dispatches) is the reference's
        e, r = _exact(got), _exact(ref)
        for k in ("recovery_events", "ckpt_steps", "n_devices_active", "step_idx",
                  "dropped_total"):
            assert e[k] == r[k], k
        np.testing.assert_array_equal(got["box_counts"], ref["box_counts"])
        np.testing.assert_allclose(got["ke64"], ref["ke64"], rtol=oracle.KE64_RTOL)
        for c in range(6):
            a, b = ref["fields"][c], got["fields"][c]
            assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), c
    kinds = [ev["kind"] for ev in _exact(got)["recovery_events"]]
    if case == "worker_exc":
        assert "ckpt_error" in kinds and "restore" not in kinds
    else:
        assert "fail" in kinds and "restore" in kinds


def _problem():
    return laser_ion_problem(nz=32, nx=32, box_cells=8, ppc=2, device="cpu")


def _make(pipeline="sync"):
    def make(n_devices):
        return ShardedRuntime(_problem(), n_devices, lb_interval=INTERVAL,
                              pipeline=pipeline, device="cpu")

    return make


def _assert_same_physics(rt, ref):
    f = np.stack([np.asarray(c) for c in rt.fields])
    f_ref = np.stack([np.asarray(c) for c in ref.fields])
    assert np.abs(f - f_ref).max() <= 2e-5 * max(float(np.abs(f_ref).max()), 1e-30)
    assert rt.total_alive() == ref.total_alive()
    assert rt.dropped_total == 0


def _events(runner, kind):
    return [e for e in runner.events if e["kind"] == kind]


def test_snapshot_restore_roundtrip_continues_identically():
    make = _make("async")
    rt = make(1)
    rt.run(4)
    snap = rt.snapshot()
    rt2 = make(1)
    rt2.restore(snap)
    assert rt2.step_idx == rt.step_idx
    rt.run(4)
    rt2.run(4)
    _assert_same_physics(rt2, rt)


def test_checkpoint_roundtrip_through_disk(tmp_path):
    make = _make()
    rt = make(1)
    rt.run(4)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save_async(rt.snapshot(), step=rt.step_idx)
    tree, step = mgr.restore(None)
    assert step == 4
    rt2 = make(1)
    rt2.restore(tree)
    rt.run(4)
    rt2.run(4)
    _assert_same_physics(rt2, rt)


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_one_sync_per_interval_survives_recovery(pipeline, tmp_path):
    inj = FaultInjector(FaultSchedule([Fault("kill_device", interval=1, device=1)]))
    runner = RecoveryRunner(_make(pipeline), 2, ckpt_dir=tmp_path, injector=inj)
    runner.run(STEPS)
    rt = runner.runtime
    rt.flush()
    h0 = rt.host_syncs
    runner.run(2 * INTERVAL)  # two more clean intervals (the runner flushes at its checkpoint)
    assert rt.host_syncs == h0 + 2
    ref = _make()(1)
    ref.run(STEPS + 2 * INTERVAL)
    _assert_same_physics(rt, ref)


def test_last_device_loss_is_terminal(tmp_path):
    inj = FaultInjector(FaultSchedule([Fault("kill_device", interval=1, device=0)]))
    runner = RecoveryRunner(_make(), 1, ckpt_dir=tmp_path, injector=inj)
    with pytest.raises(RecoveryError, match="last remaining device"):
        runner.run(STEPS)
    terms = _events(runner, "terminal")
    assert terms and "last remaining device" in terms[0]["error"]
    tree, step = runner.ckpt.restore(None)
    assert step >= 0


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_straggler_spike_absorbed_without_restore(pipeline, tmp_path):
    inj = FaultInjector(FaultSchedule(
        [Fault("straggler_spike", interval=1, device=1, magnitude=8.0, span=2)]
    ))
    runner = RecoveryRunner(_make(pipeline), 2, ckpt_dir=tmp_path, injector=inj)
    runner.run(6 * INTERVAL)
    assert not _events(runner, "restore") and not _events(runner, "fail")
    caps = runner.runtime.balancer.capacities
    assert caps is not None and caps[1] < caps[0]
    assert runner.runtime.dropped_total == 0


def test_checkpoint_cadence_every_two_intervals(tmp_path):
    runner = RecoveryRunner(_make("async"), 1, ckpt_dir=tmp_path, ckpt_every=2, keep=10)
    runner.run(STEPS)
    assert available_steps(tmp_path) == [0, 4, 8]


def test_poison_reaches_the_runtime_state():
    rt = _make()(1)
    rt.run(INTERVAL)
    FaultInjector(FaultSchedule()).poison(rt)
    assert np.isnan(rt._alive_by_box).all()
    assert np.isnan(rt.balancer._smoother._state).all()


def test_seeded_schedule_matches_reference():
    from repro.dist import FaultSchedule as JSchedule

    kw = dict(seed=7, n_intervals=50, rate=0.2, kinds=("kill_device", "nan_history"), n_devices=4)
    a, b = FaultSchedule(**kw), FaultSchedule(**kw)
    assert a.to_json() == b.to_json() == JSchedule(**kw).to_json()
    assert a.to_json()
    with pytest.raises(ValueError, match="kind"):
        Fault("meteor", interval=0)


def test_elastic_runner_matches_reference():
    """The same seeded costs through both packages' ElasticRunner, across a
    failure and a scale-up: the same events, mappings and efficiencies."""
    from repro.dist import ElasticRunner as JElastic

    rng = np.random.default_rng(0)
    runs = [ElasticRunner(4, 32, interval=2), JElastic(4, 32, interval=2)]
    for step in range(12):
        costs = rng.gamma(2.0, 1.0, 32)
        if step == 5:
            for r in runs:
                r.fail_device(1)
        if step == 9:
            for r in runs:
                r.add_device()
        for r in runs:
            r.step(step, costs)
    port, ref = runs
    assert port.events == ref.events
    assert port.efficiency_history == ref.efficiency_history
    np.testing.assert_array_equal(port.lb.mapping, ref.lb.mapping)
    assert port.slot_ids == ref.slot_ids


def test_elastic_runner_last_device_terminal_event():
    er = ElasticRunner(n_devices=1, n_boxes=4, interval=2)
    with pytest.raises(RuntimeError, match="last remaining device"):
        er.fail_device(0)
    assert any(e["kind"] == "terminal" for e in er.events)
    assert er.lb.n_devices == 1


# ---------------------------------------------------------------------------
# RecoveryRunner over BoxRuntime (tests/test_recovery.py, kind="box")
# ---------------------------------------------------------------------------


def _box_spec(pipeline, faults, **runner):
    return ("laser", 1, dict(lb_interval=INTERVAL, pipeline=pipeline),
            [("recover", dict(faults=faults, steps=STEPS, runner=runner))])


@pytest.mark.parametrize("case,pipeline", [("nan_history", "async"), ("worker_exc", "sync"),
                                           ("torn_ckpt", "sync"), ("nan_twice", "async")])
def test_box_chaos_matches_reference(case, pipeline):
    """``nan_history`` (async) and ``worker_exc`` are the reference's box
    cases; the reference's box runtime restores in place under either
    pipeline, so these are held to its own pipeline."""
    import test_torch_box_runtime as box

    spec = _box_spec(pipeline, CHAOS[case])
    got, ref = box.box_port(spec), box.box_reference(spec)
    box.assert_box_matches(got, ref)
    kinds = [ev["kind"] for ev in _exact(got)["recovery_events"]]
    if case == "worker_exc":
        assert "ckpt_error" in kinds and "restore" not in kinds
    else:
        assert "fail" in kinds and "restore" in kinds
        assert not any(ev["kind"] == "degrade" and ev["what"] == "mig_cap"
                       for ev in _exact(got)["recovery_events"])


def _make_box(pipeline="sync"):
    from repro_torch.dist import BoxRuntime

    def make(n_devices):
        return BoxRuntime(_problem(), n_devices, lb_interval=INTERVAL, pipeline=pipeline,
                          device="cpu")

    return make


def _assert_box_physics(rt, ref):
    f = np.stack([np.asarray(c) for c in rt.fields])
    f_ref = np.stack([np.asarray(c) for c in ref.fields])
    assert np.abs(f - f_ref).max() <= 1e-5 * max(float(np.abs(f_ref).max()), 1e-30)
    assert rt.total_alive() == ref.total_alive()
    np.testing.assert_array_equal(rt.box_counts(), ref.box_counts())


def test_box_snapshot_restore_roundtrip_continues_identically():
    make = _make_box("async")
    rt = make(1)
    rt.run(4)
    snap = rt.snapshot()
    rt2 = make(1)
    rt2.restore(snap)
    assert rt2.step_idx == rt.step_idx
    rt.run(4)
    rt2.run(4)
    _assert_box_physics(rt2, rt)


def test_box_checkpoint_roundtrip_through_disk(tmp_path):
    make = _make_box()
    rt = make(1)
    rt.run(4)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save_async(rt.snapshot(), step=rt.step_idx)
    tree, step = mgr.restore(None)
    assert step == 4
    rt2 = make(1)
    rt2.restore(tree)
    rt.run(4)
    rt2.run(4)
    _assert_box_physics(rt2, rt)


def test_box_last_device_loss_is_terminal(tmp_path):
    inj = FaultInjector(FaultSchedule([Fault("kill_device", interval=1, device=0)]))
    runner = RecoveryRunner(_make_box(), 1, ckpt_dir=tmp_path, injector=inj)
    with pytest.raises(RecoveryError, match="last remaining device"):
        runner.run(STEPS)
    terms = _events(runner, "terminal")
    assert terms and "last remaining device" in terms[0]["error"]
    tree, step = runner.ckpt.restore(None)
    assert step >= 0


def test_box_checkpoint_cadence_every_two_intervals(tmp_path):
    runner = RecoveryRunner(_make_box(), 1, ckpt_dir=tmp_path, ckpt_every=2, keep=10)
    runner.run(STEPS)
    assert available_steps(tmp_path) == [0, 4, 8]


def test_box_poison_reaches_the_runtime_state():
    rt = _make_box()(1)
    rt.run(INTERVAL)
    FaultInjector(FaultSchedule()).poison(rt)
    assert np.isnan(rt._counts).all()
    assert np.isnan(rt.balancer._smoother._state).all()
