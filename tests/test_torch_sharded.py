"""The port's ``ShardedRuntime`` on one device against the reference's, in
process (the reference runs on its one CPU device).

Port ``"torch"`` is held to reference ``"xla"`` with the balancer left to
itself (both feed it ``box_work_counters`` of the alive counts); port
``"cuda"`` (the kernels' plain versions on CPU tensors) with
``improvement_threshold=10.0``, as the reference's own backend oracle does,
since its work signal is the in-kernel counters.  Fields within
2e-5·max|ref|, energies rtol 1e-4; census, drops, LB steps, fetch and
dispatch counts, ``comm_stats()`` and ``migration_stats()`` exact
(``assert_matches`` below).  The multi-device cases are in
``test_torch_sharded_multi.py``.

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


PROBLEM = dict(nz=32, nx=32, box_cells=8, ppc=2)
BEAMS = dict(nz=32, nx=32, box_cells=8, ppc=4)


def _forced(mapping, n):
    """The forced adoption: every box to the next device on the ring
    (equal counts kept)."""
    return (np.asarray(mapping) + 1) % n


#: name -> (problem, n_devices, runtime kwargs, script); a script is a list
#: of ("run", steps) / ("force",) / ("straggle",) / ("restore", n) actions
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


def problem(name, laser_ion, beams, **kw):
    return (laser_ion(**PROBLEM, **kw) if name == "laser" else beams(**BEAMS, **kw))


def drive(make, detector_cls, n, script):
    """Apply ``script`` to ``make(n)``; returns the runtime at the end."""
    rt = make(n)
    for action in script:
        if action[0] == "run":
            rt.run(action[1])
        elif action[0] == "force":
            rt.apply_mapping(_forced(rt.balancer.mapping, n))
        elif action[0] == "straggle":
            # the last device is four times slower than the others
            times = np.ones(n)
            times[-1] = 4.0
            rt.attach_straggler_detector(detector_cls(n, alpha=1.0), time_fn=lambda r, e: times)
        elif action[0] == "restore":
            snap = rt.snapshot()
            rt = make(action[1])
            rt.restore(snap)
    return rt


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


def summary(rt) -> dict:
    f = rt.fields
    caps = rt.balancer.capacities
    return {
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
                }
            )
        ),
    }


def assert_matches(port: dict, ref: dict) -> None:
    assert json.loads(str(port["exact"])) == json.loads(str(ref["exact"]))
    np.testing.assert_array_equal(port["box_counts"], ref["box_counts"])
    np.testing.assert_array_equal(port["mapping"], ref["mapping"])
    np.testing.assert_allclose(port["capacities"], ref["capacities"], rtol=1e-12)
    for key in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-4, atol=1e-12, err_msg=key)
    for c in range(6):
        a, b = ref["fields"][c], port["fields"][c]
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), c


def reference(spec) -> dict:
    """The reference's summary of ``spec`` (needs enough jax devices)."""
    from repro.dist.sharded_runtime import ShardedRuntime
    from repro.dist.straggler import StragglerDetector
    from repro.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return ShardedRuntime(problem(prob, laser_ion_problem, colliding_beams_problem), k,
                              engine_backend="xla", **kw)

    return summary(drive(make, StragglerDetector, n, script))


def port(spec, engine_backend: str) -> dict:
    """The port's summary of ``spec`` on logical CPU devices."""
    from repro_torch.dist import ShardedRuntime, StragglerDetector
    from repro_torch.pic import colliding_beams_problem, laser_ion_problem

    prob, n, kw, script = spec

    def make(k):
        return ShardedRuntime(
            problem(prob, laser_ion_problem, colliding_beams_problem, device="cpu"), k,
            engine_backend=engine_backend, device="cpu", **kw,
        )

    return summary(drive(make, StragglerDetector, n, script))



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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        validate_pipeline("async")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShardedRuntime(_cpu_problem(), 1, device="cpu", pipeline="async")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
