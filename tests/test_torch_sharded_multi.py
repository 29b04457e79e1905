"""The port's ``ShardedRuntime`` on 2 and 4 logical CPU devices against the
reference's on 2 and 4 fake jax devices.

The reference runs every case of ``test_torch_sharded.MULTI_CASES`` once, in
one subprocess started with ``XLA_FLAGS=--xla_force_host_platform_device_
count=4`` (this process keeps its one jax device), and writes their
summaries to an ``.npz``.  The port runs each case in process: both
``comm`` modes with the balancer adopting on its own (port ``"torch"``,
the reference's ``"xla"`` work signal) and through one forced adoption
(both port backends, ``improvement_threshold=10.0``), the straggler loop,
and a snapshot taken on 2 devices restored on 1.  Fields within
2e-5·max|ref|, energies rtol 1e-4; census, drops, LB steps and events,
mappings, fetch and dispatch counts, ``comm_stats()``,
``migration_stats()``, ``hop_radius()`` and straggler capacities exact.
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
        name: {k: data[f"{name}/{k}"] for k in ("fields", "field_energy", "kinetic_energy",
                                               "box_counts", "mapping", "capacities", "exact")}
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
