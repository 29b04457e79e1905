"""The port's ``ShardedRuntime`` on 2 and 4 logical CPU devices against the
reference's on 2 and 4 fake jax devices, under both pipelines and under
``RecoveryRunner``.

The reference runs every case of ``test_torch_sharded.MULTI_CASES`` once, in
one subprocess started with ``XLA_FLAGS=--xla_force_host_platform_device_
count=4`` (this process keeps its one jax device), and writes their
summaries to an ``.npz``.  The port runs each case in process: both
``comm`` modes with the balancer adopting on its own (port ``"torch"``,
the reference's ``"xla"`` work signal) and through one forced adoption
(both port backends, ``improvement_threshold=10.0``), the straggler loop,
and a snapshot taken on 2 devices restored on 1.  Fields within
2e-5·max|ref|, and the rest of ``oracle.assert_matches``: the final
particle arrays within 2e-5·max|ref|, their float64 kinetic energy rtol
1e-6, the float32 energy histories at ``FE_RTOL`` and ``KE_RTOL``; census, drops, LB steps and events,
mappings, fetch and dispatch counts, ``comm_stats()``,
``migration_stats()``, ``hop_radius()`` and straggler capacities exact.

``pipeline="async"``: the balancer adopting on its own at 2 and 4 devices
in both ``comm`` modes, and a forced adoption (skewed capacities) that
lands one interval after sync's.  Recovery: a device killed at interval 2
on 2 devices (both pipelines) and on 4 (the rebuild degrades to 2, the
largest count that divides the boxes), the degradation ladder and a seeded
schedule of corruption and torn writes; ``RecoveryRunner.events`` (without
wall times) and the steps left on disk are exact.  The reference's async
runtime cannot restore in place after a corrupt-state fault (its restore
harvests the round in flight into the poisoned balancer and raises), so
the port's async runs of the last two are held to the reference's sync
events, census, fields and float64 kinetic energy.

``overlap=True`` (split-phase stepping, port ``"torch"``): both ``comm``
modes at 2 and 4 devices with the adoption gate open and one forced
adoption, on 16-cell boxes (8-cell boxes are all frontier).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_sharded as oracle

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    proc = subprocess.run(
        [sys.executable, str(HERE / "test_torch_sharded.py"), str(out)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"
    data = np.load(out)
    return {
        name: {
            k.split("/", 1)[1]: data[k] for k in data.files if k.split("/", 1)[0] == name
        }
        for name in oracle.MULTI_CASES
    }


def _check(name, backend, reference):
    got = oracle.port(oracle.MULTI_CASES[name], backend)
    oracle.assert_matches(got, reference[name])
    return json.loads(str(got["exact"]))


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
@pytest.mark.parametrize("n", [2, 4])
def test_balancer_adopts_as_reference(n, comm, reference):
    _check(f"auto-{n}-{comm}", "torch", reference)


def test_some_autonomous_case_adopts(reference):
    """The configuration makes the reference adopt on its own somewhere,
    so the exact LB comparison above has something to compare."""
    adopted = [
        name for name in oracle.MULTI_CASES
        if name.startswith("auto") and json.loads(str(reference[name]["exact"]))["lb_steps"]
    ]
    assert adopted


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("comm", ["neighbor", "ring"])
@pytest.mark.parametrize("n", [2, 4])
def test_forced_adoption_matches_reference(n, comm, backend, reference):
    exact = _check(f"forced-{n}-{comm}", backend, reference)
    assert exact["lb_steps"] == [] and exact["dropped_total"] == 0


def test_straggler_loop_matches_reference(reference):
    exact = _check("straggler-4-neighbor", "torch", reference)
    caps = reference["straggler-4-neighbor"]["capacities"]
    assert caps.shape == (4,) and caps[-1] < 1.0  # the slow device was seen
    assert exact["lb_steps"]


def test_snapshot_on_two_restored_on_one_matches_reference(reference):
    exact = _check("restore-2-to-1", "torch", reference)
    assert exact["step_idx"] == 8


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
@pytest.mark.parametrize("n", [2, 4])
def test_overlap_matches_reference(n, comm, reference):
    exact = _check(f"overlap-{n}-{comm}", "torch", reference)
    assert exact["dropped_total"] == 0 and len(exact["events"]) == 3


def _async_variant(name):
    prob, n, kw, script = oracle.MULTI_CASES[name]
    return (prob, n, dict(kw, pipeline="async"), script)


def _recovery(exact):
    return {k: exact[k] for k in ("recovery_events", "ckpt_steps", "n_devices_active")}


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
@pytest.mark.parametrize("n", [2, 4])
def test_async_matches_reference(n, comm, reference):
    exact = _check(f"async-{n}-{comm}", "torch", reference)
    assert exact["pipeline"] == "async" and exact["host_syncs"] == 3


def test_some_async_case_adopts(reference):
    assert any(
        json.loads(str(reference[f"async-{n}-{c}"]["exact"]))["lb_steps"]
        for n in (2, 4) for c in ("neighbor", "ring")
    )


def test_async_adoption_lands_one_interval_after_sync(reference):
    """The staleness contract against the reference: sync adopts at the
    first boundary, async one interval later, with the same mapping; both
    record the adoption at its measurement round and conserve particles."""
    sync = _check("late-2-sync", "torch", reference)
    late = _check("late-2-async", "torch", reference)
    m0, m_sync, m_async = sync["mappings"][0], sync["mappings"], late["mappings"]
    assert m_sync[1] != m0
    assert m_async[1] == m0 and m_async[2] == m_sync[1]
    assert sync["lb_steps"] == late["lb_steps"] == [0]
    assert late["dropped_total"] == 0


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_kill_on_two_recovers_as_reference(pipeline, reference):
    exact = _check(f"recover-kill-2-{pipeline}", "torch", reference)
    restores = [e for e in exact["recovery_events"] if e["kind"] == "restore"]
    assert len(restores) == 1 and restores[0]["ckpt_step"] == 4
    assert exact["n_devices_active"] == 1 and exact["step_idx"] == 8


def test_kill_on_four_degrades_as_reference(reference):
    exact = _check("recover-kill-4-async", "torch", reference)
    assert exact["n_devices_active"] == 2
    assert any(e.get("why") == "largest buildable count" for e in exact["recovery_events"])


def _check_recovery(name, pipeline, reference):
    if pipeline == "sync":
        return _check(name, "torch", reference)
    got, ref = oracle.port(_async_variant(name), "torch"), reference[name]
    exact, ref_exact = json.loads(str(got["exact"])), json.loads(str(ref["exact"]))
    assert _recovery(exact) == _recovery(ref_exact)
    assert exact["dropped_total"] == ref_exact["dropped_total"] == 0
    np.testing.assert_array_equal(got["box_counts"], ref["box_counts"])
    np.testing.assert_allclose(got["ke64"], ref["ke64"], rtol=oracle.KE64_RTOL)
    for c in range(6):
        a, b = ref["fields"][c], got["fields"][c]
        assert np.abs(a - b).max() <= 2e-5 * max(np.abs(a).max(), 1e-30), c
    return exact


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_degradation_ladder_matches_reference(pipeline, reference):
    exact = _check_recovery("recover-ladder-2", pipeline, reference)
    degrades = [e["what"] for e in exact["recovery_events"] if e["kind"] == "degrade"]
    assert degrades == ["mig_cap", "devices"] and exact["n_devices_active"] == 1


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_seeded_schedule_matches_reference(pipeline, reference):
    exact = _check_recovery("recover-seeded-2", pipeline, reference)
    kinds = [e["kind"] for e in exact["recovery_events"]]
    assert kinds.count("fault") == 3 and "restore" in kinds
