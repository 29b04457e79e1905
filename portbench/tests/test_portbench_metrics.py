"""The per-layer readers on a recorded event list."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import spec, trace, yardstick

#: two steps: per step one launch of each kernel, glue around them, and the
#: window (0, 10 ms); the last 2 ms of each step are idle
DEVICE = [
    ("void gather_push_kernel<...>", 0.000, 0.001),
    ("void deposition_kernel<...>", 0.001, 0.003),
    ("elementwise_glue", 0.0025, 0.004),  # overlaps the deposition: counts once when busy
    ("void gather_push_kernel<...>", 0.005, 0.006),
    ("void deposition_kernel<...>", 0.006, 0.008),
]
HOST = [
    ("portbench:interval", 0.0, 0.010),
    ("cudaStreamSynchronize", 0.0085, 0.0095),
]
COUNTS = [np.array([300.0, 0.0, 5.0]), np.array([300.0, 0.0, 5.0])]


def _ctx(device=DEVICE):
    return SimpleNamespace(
        trace=trace.Trace(device=device, host=HOST, window=(0.0, 0.010), steps=2),
        launches=COUNTS, tile_cells=70 * 70, alive_per_step=[305.0, 305.0], cells=64 * 64,
        step_bounds_s=[yardstick.step_bound_s(305.0, 64 * 64)] * 2,
        host={"steps": 20, "intervals": 2, "dispatch_s": 0.5, "balance_s": 0.1, "fetch_s": 0.2},
        remake_s=[0.004, 0.006],
    )


def _read(name, ctx):
    return spec.load("laser_ion.sharded4").reader(name)(ctx)


def test_rooflines():
    b, f = zip(*(yardstick.gather_push_work(c, 70 * 70) for c in COUNTS))
    want = 100 * yardstick.bound_s(sum(b), sum(f)) / 0.002
    assert _read("roofline.gather_push", _ctx()) == pytest.approx(want)
    b, f = zip(*(yardstick.deposition_work(c, 70 * 70) for c in COUNTS))
    want = 100 * yardstick.bound_s(sum(b), sum(f)) / 0.004
    assert _read("roofline.deposition", _ctx()) == pytest.approx(want)
    # executed lanes: 300 particles run two 256-lane chunks, 5 run one
    assert yardstick.executed_lanes(COUNTS[0]).sum() == 768


def test_deposition_counts_the_momenta_form():
    """24 B a lane (z, x, ux, uy, uz, w) and 324 operations, on both paths."""
    b, f = yardstick.deposition_work(np.array([256.0, 0.0, 1.0]), 70 * 70)
    assert b == 24 * 512 + 12 * 70 * 70 * 3 + 8 * 3
    assert f == 512 * 324
    # the deposit's share of the whole step: 24 B a particle, byte-bound
    deposit = yardstick.step_bound_s(1e6, 0) - yardstick.bound_s(40e6, 512e6)
    assert deposit == pytest.approx(24e6 / yardstick.PEAK_BYTES_PER_S)


def test_idle_glue_and_step_bound():
    assert _read("device_idle_share", _ctx()) == pytest.approx(100 * (1 - 0.007 / 0.010))
    assert _read("glue_device_ms", _ctx()) == pytest.approx(1e3 * 0.0015 / 2)
    want = 100 * 2 * yardstick.step_bound_s(305.0, 64 * 64) / 0.010
    assert _read("step_mfu", _ctx()) == pytest.approx(want)


def test_program_clocks():
    assert _read("dispatch_ms", _ctx()) == pytest.approx(25.0)
    assert _read("balance_ms", _ctx()) == pytest.approx(50.0)
    assert _read("remake_ms", _ctx()) == pytest.approx(5.0)


def test_nothing_to_read_gives_nothing():
    empty = _ctx(device=[("elementwise_glue", 0.0, 0.001)])
    assert _read("roofline.gather_push", empty) is None
    assert _read("roofline.deposition", empty) is None
    bare = _ctx(device=[])
    for name in ("glue_device_ms", "device_idle_share", "step_mfu"):
        assert _read(name, bare) is None
    ctx = _ctx()
    ctx.host = {"steps": 20, "intervals": 2}
    assert _read("dispatch_ms", ctx) is None and _read("balance_ms", ctx) is None


def test_breakdown():
    bd = trace.breakdown(_ctx().trace)
    assert bd["device_ops"][0] == ["void deposition_kernel<...>", pytest.approx(0.004)]
    gaps = dict(bd["idle_gaps"])
    # idle 0.004-0.005 under the interval span, 0.008-0.010 partly in the sync
    assert gaps["portbench:interval"] == pytest.approx(0.001)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.002)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
