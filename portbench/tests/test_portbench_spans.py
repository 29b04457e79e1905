"""The readers of the program's spans on a synthetic span buffer and
trace, and traced runs at the small size on the CPU, whose host spans they
read: the DLB loop's times of every cost strategy, no device metric."""
import sys
from types import SimpleNamespace

import pytest
import torch

from _small import CONFIG, SEED, TRAFFIC
from portbench import harness, spec, trace

import repro_torch
from repro_torch import _trace

STAGES = ["bin", "push", "deposit", "unbin", "field", "diag"]
#: the metrics that read the program's spans
NEW = [f"stage_ms.{s}" for s in STAGES] + ["launches_per_step", "assess_ms", "decide_ms"]


class FakeSpan:
    def __init__(self, name, ms):
        self.name, self._ms = name, ms

    def device_ms(self):
        return self._ms


#: two steps; in each, one span per stage, the deposit twice (two species)
BUFFER = [
    FakeSpan(name, ms)
    for _ in range(2)
    for name, ms in [("pic.step", 9.0), ("pic.bin", 1.0), ("pic.push", 0.5), ("pic.deposit", 0.25),
                     ("pic.deposit", 0.75), ("pic.unbin", 2.0), ("pic.field", 0.125),
                     ("pic.diag", 0.0625), ("dlb.book", None)]
]
HOST = [
    ("dlb.issue", 0.0, 0.0031),
    ("pic.step", 0.0, 0.001),
    ("cudaLaunchKernel", 0.0001, 0.0002),
    ("cudaMemsetAsync", 0.0003, 0.0004),
    ("cudaStreamSynchronize", 0.0005, 0.0006),  # puts no work on the device
    ("cudaLaunchKernel", 0.0015, 0.0016),  # between the steps
    ("pic.step", 0.002, 0.003),
    ("cuLaunchKernel", 0.0021, 0.0022),
    ("cudaMemcpyAsync", 0.0025, 0.0026),
    ("cudaLaunchKernelExC", 0.0027, 0.0028),
    ("dlb.measure", 0.004, 0.006),
    ("dlb.decide", 0.006, 0.0061),
    ("dlb.measure", 0.007, 0.008),
    ("dlb.decide", 0.008, 0.0083),
]


def _ctx(host=HOST):
    return SimpleNamespace(trace=trace.Trace(device=[], host=host, window=(0.0, 0.01), steps=2))


def _read(name, ctx):
    return spec.load("laser_ion.sim").reader(name)(ctx)


@pytest.fixture
def buffer(monkeypatch):
    monkeypatch.setattr(_trace, "spans", lambda: list(BUFFER))


@pytest.mark.parametrize(
    "stage,want", zip(STAGES, [1.0, 0.5, 1.0, 2.0, 0.125, 0.0625]), ids=STAGES
)
def test_stage_ms_sums_device_extents_per_step(buffer, stage, want):
    assert _read(f"stage_ms.{stage}", _ctx()) == pytest.approx(want)


def test_launches_count_work_calls_inside_steps():
    # 2 in the first step, 3 in the second; the sync and the launch between
    # the steps are not counted
    assert _read("launches_per_step", _ctx()) == pytest.approx(2.5)


def test_dlb_host_times_per_round():
    assert _read("assess_ms", _ctx()) == pytest.approx(1.5)
    assert _read("decide_ms", _ctx()) == pytest.approx(0.2)


def test_nothing_to_read_gives_nothing(monkeypatch):
    bare = _ctx(host=[("portbench:interval", 0.0, 0.01), ("cudaLaunchKernel", 0.001, 0.002)])
    monkeypatch.setattr(_trace, "spans", lambda: [FakeSpan("pic.bin", None)])  # on CPU tensors
    for name in NEW:
        assert _read(name, bare) is None, name
    # a program without the tracer, as the parent of the change that added it
    monkeypatch.delattr(repro_torch, "_trace")
    monkeypatch.setitem(sys.modules, "repro_torch._trace", None)
    for s in STAGES:
        assert _read(f"stage_ms.{s}", _ctx()) is None


@pytest.mark.parametrize("strategy", ["work_counter", "activity_ledger"])
def test_traced_run_reads_the_dlb_spans(strategy):
    """On the CPU a traced run has host spans and no device extents: the
    DLB loop's times are read, the device metrics left out, whichever
    strategy assesses the costs (the activity ledger times every occupied
    (species, box) deposit)."""
    r = harness.run_cell(
        spec.load("laser_ion.sim"), SEED, 0.0, True, device=torch.device("cpu"),
        config_overrides=CONFIG, traffic_overrides=dict(TRAFFIC, cost_strategy=strategy),
    )
    assert r["correct"]
    got = {k: v for k, v in r["metrics"].items() if k in NEW}
    assert set(got) == {"assess_ms", "decide_ms"}, r["metrics"]
    assert all(v["value"] > 0 and v["unit"] == "ms/round" for v in got.values())
