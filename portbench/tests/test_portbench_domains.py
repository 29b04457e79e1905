"""The domain layer: a toy domain that is not PIC, defined here alone, runs
end to end through ``harness.run_cell`` from a ``spec.Cell`` built here,
and reads not correct with a fault planted in its entry."""
import sys
from types import SimpleNamespace

import pytest
import torch

import _toy
from portbench import control, domains, harness, spec, trace

E2E = [{"name": n, "unit": u} for n, u in [("step_ms", "ms/step"), ("peak_mem_gib", "GiB"), ("setup_s", "s")]]


def _cell():
    return spec.Cell(
        name="toy.demo", chips=1,
        config={"domain": "toy", "rows": 64, "width": 8},
        traffic={"entry": "toy", "steps_per_interval": 4, "stretch_intervals": 3, "trace_intervals": 2},
        limits={"gap": 1e-5},
        end_to_end=E2E,
        per_layer=[{"name": "remake_ms", "unit": "ms/stretch"}, {"name": "step_mfu", "unit": "%"}],
    )


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, "portbench.domains.toy", _toy)
    monkeypatch.setitem(sys.modules, "portbench.entries.toy", _toy)


def _run(trace):
    return harness.run_cell(_cell(), 2**31 + 7, 0.0, trace, device=torch.device("cpu"))


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_toy_domain_runs_through_the_harness(toy, trace):
    r = _run(trace)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"gap"} and r["checks"]["gap"]["value"] < 1e-6
    assert r["attempted"] == 12 and r["failed"] == 0
    if trace:
        # no device on the CPU: step_mfu has nothing to read
        assert set(r["metrics"]) == {"remake_ms"} and r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}


def test_fault_in_toy_entry_is_not_correct(toy, monkeypatch):
    monkeypatch.setattr(_toy, "step", lambda x: x)  # a step that hands back its state
    r = _run(False)
    assert not r["correct"] and r["checks"]["gap"]["value"] > r["checks"]["gap"]["limit"]


def test_step_mfu_reads_the_domains_bound():
    plain = _toy.draw(_cell().config, 1, "cpu")
    entry = SimpleNamespace(interval=4)
    ctx = SimpleNamespace(
        trace=trace.Trace(device=[("k", 0.0, 1e-3)], host=[], window=(0.0, 1e-3), steps=8),
        **_toy.context(entry, [{}, {}], plain),
    )
    # two intervals of four steps, each reading and writing 64 x 8 float32
    want = 100 * 8 * (2 * 4 * 64 * 8 / _toy.PEAK_BYTES_PER_S) / 1e-3
    assert _cell().reader("step_mfu")(ctx) == pytest.approx(want)


def test_domain_without_a_control_says_so(toy):
    with pytest.raises(control.NoControl, match="toy"):
        control.readings(_cell(), 1, device="cpu")


def test_configurations_without_a_domain_are_pic():
    assert domains.name({"scenario": "laser_ion"}) == "pic"
    assert domains.module(spec.load("laser_ion.sim").config).__name__ == "portbench.domains.pic"
