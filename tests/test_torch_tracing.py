"""The port's spans (``repro_torch._trace``) on the CPU at tiny grids.

  * with no profiler active nothing is recorded, and a span is one shared
    no-op context;
  * under ``torch.profiler``, ``Simulation`` (the binned kernel path on CPU
    tensors, fused and step by step) and ``ShardedRuntime`` issue the spans
    of the PIC step and the DLB loop in order per step, with their parents,
    steps and logical devices, each also a host event of the profiler;
  * a traced and an untraced run give bitwise-identical state and
    histories;
  * the buffer is bounded and holds only the latest session;
  * ``interval_trace`` still returns only ``split_phase:*`` spans.

No timing is asserted: on CPU tensors a span has no device extent.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import _trace
from repro_torch.dist import ShardedRuntime
from repro_torch.pic import Simulation, SimConfig, laser_ion_problem

PROBLEM = dict(nz=32, nx=32, box_cells=8, ppc=2)
INTERVAL = 2
#: a binned step, per species, then the field solve and the outputs
SPECIES_STAGES = ["pic.bin", "pic.push", "pic.deposit", "pic.unbin"]
#: a slot step's particle phase on one logical device: the tile split, then
#: per species
SLOT_STAGES = ["pic.push", "pic.push", "pic.deposit", "pic.unbin"]


def _sim(fused=True):
    return Simulation(
        laser_ion_problem(**PROBLEM, device="cpu"),
        SimConfig(engine_backend="cuda", n_virtual_devices=4, lb_interval=INTERVAL, fused=fused),
        device="cpu",
    )


def _sharded(n_devices=2, **kw):
    return ShardedRuntime(
        laser_ion_problem(**PROBLEM, device="cpu"), n_devices, lb_interval=INTERVAL,
        engine_backend=kw.pop("engine_backend", "cuda"), device="cpu", **kw,
    )


def _traced(run):
    """``run()`` under the profiler: the tracer's spans and the names of
    the profiler's host events."""
    _trace.spans()  # what was there belongs to an earlier session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return _trace.spans(), [e.name for e in prof.events()]


def _children(spans, parent):
    return [s for s in spans if s.parent is parent]


def test_untraced_run_records_nothing():
    before = _trace.spans()
    assert _trace.span("pic.step") is _trace.span("dlb.book", step=3) is _trace.step()
    _sim().run(INTERVAL)
    _sharded().run(INTERVAL)
    after = _trace.spans()
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))


@pytest.mark.parametrize("fused", [True, False])
def test_simulation_spans_per_step(fused):
    sim = _sim(fused)
    n_steps = 2 * INTERVAL
    spans, host = _traced(lambda: sim.run(n_steps))
    n_species = len(sim.species)

    steps = [s for s in spans if s.name == "pic.step"]
    assert [s.step for s in steps] == list(range(n_steps))
    for s in steps:
        assert s.parent.name == "dlb.issue" and s.device is None
        kids = _children(spans, s)
        assert [k.name for k in kids] == SPECIES_STAGES * n_species + ["pic.field", "pic.diag"]
        assert all(k.step == s.step and k.device_ms() is None for k in kids)

    issues = [s for s in spans if s.name == "dlb.issue"]
    per_issue = INTERVAL if fused else 1
    assert [s.step for s in issues] == list(range(0, n_steps, per_issue))
    assert all(s.parent is None for s in issues)
    books = [s for s in spans if s.name == "dlb.book"]
    assert [b.step for b in books] == [s.step for s in issues]
    rounds = [b for b in books if _children(spans, b)]
    assert [b.step for b in rounds] == list(range(0, n_steps, INTERVAL))
    for b in rounds:
        assert [k.name for k in _children(spans, b)] == ["dlb.measure", "dlb.decide"]
    # each span is also the profiler's host event of the same name
    for name in ("pic.step", "pic.bin", "pic.field", "dlb.measure", "dlb.decide"):
        assert host.count(name) == sum(s.name == name for s in spans), name


def test_sharded_spans_per_step():
    rt = _sharded(2)
    n_steps = 2 * INTERVAL
    spans, host = _traced(lambda: rt.run(n_steps))
    n_species, n_dev = len(rt._qm), rt.n_devices

    steps = [s for s in spans if s.name == "pic.step"]
    assert [s.step for s in steps] == list(range(n_steps))
    slot_stages = SLOT_STAGES[:1] + SLOT_STAGES[1:] * n_species
    for s in steps:
        assert s.parent.name == "dlb.issue"
        kids = _children(spans, s)
        want = (
            [("pic.halo", None)]
            + [(name, d) for d in range(n_dev) for name in slot_stages]
            + [("pic.fold", None)]
            + [("pic.field", d) for d in range(n_dev)]
            + [("pic.exchange", None), ("pic.diag", None)] * n_species
            + [("pic.diag", None)]
        )
        assert [(k.name, k.device) for k in kids] == want
        assert all(k.step == s.step for k in kids)

    books = [s for s in spans if s.name == "dlb.book"]
    assert [b.step for b in books] == list(range(0, n_steps, INTERVAL))
    for b in books:
        assert [k.name for k in _children(spans, b)][:1] == ["dlb.decide"]
        assert all(k.name in ("dlb.decide", "dlb.adopt") for k in _children(spans, b))
    assert host.count("dlb.issue") == n_steps // INTERVAL
    assert host.count("pic.exchange") == n_steps * n_species


def test_adoption_is_a_span():
    rt = _sharded(2)
    rt.run(INTERVAL)
    new = np.asarray(rt.balancer.mapping)[::-1].copy()
    spans, _ = _traced(lambda: rt.apply_mapping(new))
    assert [s.name for s in spans] == ["dlb.adopt"] and spans[0].parent is None


def _state(runtime):
    if isinstance(runtime, Simulation):
        tensors = list(runtime.fields) + [t for p in runtime.species for t in p[:7]]
    else:
        snap = runtime.snapshot()
        tensors = [torch.as_tensor(np.asarray(snap["tiles"]))] + [
            torch.as_tensor(np.asarray(v)) for sp in snap["species"] for v in sp.values()
        ]
    return tensors, runtime.history


@pytest.mark.parametrize("make", [_sim, _sharded], ids=["simulation", "sharded"])
def test_traced_run_is_bitwise_identical(make):
    plain, traced = make(), make()
    plain.run(2 * INTERVAL)
    _traced(lambda: traced.run(2 * INTERVAL))
    (a, ha), (b, hb) = _state(plain), _state(traced)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ha == hb


def test_buffer_is_bounded_and_holds_the_latest_session(monkeypatch):
    monkeypatch.setattr(_trace, "MAX_SPANS", 5)

    def spans_named(name, n):
        for _ in range(n):
            with _trace.span(name):
                pass

    first, host = _traced(lambda: spans_named("first", 8))
    assert [s.name for s in first] == ["first"] * 5
    assert host.count("first") == 8  # the profiler still sees every span
    second, _ = _traced(lambda: spans_named("second", 2))
    assert [s.name for s in second] == ["second"] * 2
    assert _trace.spans() == second  # read again, still the latest session


def test_interval_trace_returns_only_split_phase_spans():
    rt = _sharded(2, engine_backend="torch", overlap=True)
    _trace.spans()
    names = [name for name, _, _ in rt.interval_trace()]
    assert names and all(n.startswith("split_phase:") for n in names)
    # the tracer was on all the same: the step spans were recorded beside them
    recorded = _trace.spans()
    assert sum(s.name == "pic.step" for s in recorded) == INTERVAL
    fronts = [s for s in recorded if s.name.startswith("split_phase:frontier:")]
    assert [s.device for s in fronts] == [d for _ in range(INTERVAL) for d in range(2)]
