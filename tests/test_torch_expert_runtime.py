"""The port's ``ExpertRuntime`` held to the reference's, run for run.

Every test of ``tests/test_expert_runtime.py`` has its counterpart here.
Each drives the reference's runtime and the port's on the same params (the
reference's ``init_moe(PRNGKey(0))``, carried over through
``repro_torch.convert.params_from``) and the same seeded traffic (each
package's own ``TrafficGenerator``, bitwise equal), and holds the port to
the reference's run.  Exact: ``balancer.events``, the mapping and placement
after every step, ``interval_costs``, ``interval_loads``,
``efficiency_trace``, ``lb_adoptions``, ``host_syncs``, ``tokens_served``,
``balancer.capacities``, and the permuted params bit for bit.  Served
outputs within atol 1e-5 (``tests/test_expert_runtime.py``'s bound).

The straggler tests use a ``time_fn`` that ignores the wall clock (each
device takes 1.0 per interval, times the fault's magnitude), so the two
runs see the same times.  The hot-flip counterpart holds the port's events
to the reference's and does not assert an adoption after the flip: on this
jax the reference's own test fails, because ``init_moe(PRNGKey(0))`` draws
other params under ``jax_threefry_partitionable`` (ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.faults import Fault as RefFault
from repro.dist.faults import FaultSchedule as RefFaultSchedule
from repro.dist.straggler import StragglerDetector as RefStragglerDetector
from repro.models.common import ModelConfig as RefConfig
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe as ref_moe
from repro.serve import ExpertRuntime as RefRuntime
from repro.serve import TrafficConfig as RefTrafficConfig
from repro.serve import TrafficGenerator as RefTrafficGenerator
from repro.serve import permutation_for_mapping as ref_permutation_for_mapping
from repro_torch.convert import params_from, params_to_numpy
from repro_torch.core import efficiency
from repro_torch.core.policies import device_loads
from repro_torch.dist.faults import Fault, FaultSchedule
from repro_torch.dist.straggler import StragglerDetector
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import init_moe, moe
from repro_torch.serve import (
    ExpertRuntime,
    TrafficConfig,
    TrafficGenerator,
    permutation_for_mapping,
)

TOY = dict(
    name="serve-toy", kind="moe", n_layers=1, d_model=32, n_heads=2,
    n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, n_experts=16, top_k=2,
)
REF_CFG = RefConfig(**TOY, param_dtype=jnp.float32)
CFG = ModelConfig(**TOY, param_dtype=torch.float32)
REF_PARAMS, _ = ref_init_moe(jax.random.PRNGKey(0), REF_CFG)
PARAMS = params_from(jax.tree.map(np.asarray, REF_PARAMS), "cpu")


def skewed(seed=3, **kw):
    base = dict(seed=seed, d_model=CFG.d_model, batch=2, seq=16, n_topics=8,
                skew=2.5, period=64, night_load=0.5, flip_every=0, burst_every=0)
    base.update(kw)
    return base


def uniform(seed=3):
    # big batch: plenty of tokens per interval keeps multinomial routing
    # noise small, so this is a near-uniform load, not a jittery one
    return dict(seed=seed, d_model=CFG.d_model, batch=16, seq=32, n_topics=8,
                skew=0.0, period=64, night_load=1.0, noise=2.0)


class Pair:
    """The reference's runtime and the port's on the same params/traffic."""

    def __init__(self, traffic: dict, **kw):
        args = dict(n_devices=8, lb_interval=5)
        args.update(kw)
        self.ref = RefRuntime(REF_PARAMS, REF_CFG,
                              RefTrafficGenerator(RefTrafficConfig(**traffic)), **args)
        self.port = ExpertRuntime(PARAMS, CFG, TrafficGenerator(TrafficConfig(**traffic)),
                                  device="cpu", **args)
        self.trace = {"ref": [], "port": []}

    def run(self, n: int) -> None:
        for _ in range(n):
            for key, rt in (("ref", self.ref), ("port", self.port)):
                out = rt.step()
                self.trace[key].append((bool(out["adopted"]), tuple(rt.balancer.mapping),
                                        tuple(rt.expert_placement())))

    def flush(self) -> None:
        self.ref.flush()
        self.port.flush()

    def check(self) -> None:
        assert_same_run(self.ref, self.port)
        assert self.trace["port"] == self.trace["ref"]


def _events(rt):
    return [dataclasses.astuple(e) for e in rt.balancer.events]


def assert_same_run(ref, port) -> None:
    assert _events(port) == _events(ref)
    assert len(port.interval_costs) == len(ref.interval_costs)
    for a, b in zip(port.interval_costs, ref.interval_costs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.interval_loads, ref.interval_loads):
        np.testing.assert_array_equal(a, b)
    assert port.efficiency_trace == ref.efficiency_trace
    np.testing.assert_array_equal(port.expert_placement(), ref.expert_placement())
    np.testing.assert_array_equal(port.balancer.mapping, ref.balancer.mapping)
    assert (port.lb_adoptions, port.host_syncs, port.tokens_served, port.step_idx) == (
        ref.lb_adoptions, ref.host_syncs, ref.tokens_served, ref.step_idx)
    if ref.balancer.capacities is None:
        assert port.balancer.capacities is None
    else:
        np.testing.assert_array_equal(port.balancer.capacities, ref.balancer.capacities)
    assert_same_params(port.params, ref.params)


def assert_same_params(port_params, ref_params) -> None:
    got = params_to_numpy(port_params)
    for k in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(got[k], np.asarray(ref_params[k], np.float32))


def served(params, x):
    return moe(params, CFG, torch.from_numpy(x))[0].numpy()


def ref_served(params, x):
    return np.asarray(ref_moe(params, REF_CFG, jnp.asarray(x))[0])


# ---------------------------------------------------------------------------
# the workload-agnostic protocol
# ---------------------------------------------------------------------------


def test_all_three_runtimes_satisfy_balanced_runtime():
    """The port's BoxRuntime, ShardedRuntime and ExpertRuntime satisfy
    ``repro_torch.dist.BalancedRuntime`` structurally."""
    from repro_torch.dist import BalancedRuntime, BoxRuntime, ShardedRuntime
    from repro_torch.pic import laser_ion_problem

    def prob():
        return laser_ion_problem(nz=32, nx=32, box_cells=8, ppc=2, seed=0, device="cpu")

    box = BoxRuntime(prob(), n_devices=1, lb_interval=2, device="cpu")
    sharded = ShardedRuntime(prob(), n_devices=1, lb_interval=2, device="cpu")
    expert = Pair(skewed()).port
    for rt in (box, sharded, expert):
        assert isinstance(rt, BalancedRuntime)
        assert rt.n_slots() > 0
        assert rt.slot_costs() is None  # nothing measured yet


def test_slot_costs_surface_the_knapsack_signal():
    pair = Pair(skewed())
    pair.run(6)  # past the first LB round
    pair.check()
    costs = pair.port.slot_costs()
    assert costs is not None and costs.shape == (CFG.n_experts,)
    np.testing.assert_array_equal(costs, pair.ref.slot_costs())
    assert costs.sum() > 0
    assert pair.port.n_slots() == CFG.n_experts


@pytest.mark.parametrize("cost_source", ["work_counter", "heuristic"])
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_drifting_run_matches_reference(pipeline, cost_source):
    """Both pipelines and both cost sources on flipping, bursting traffic
    with adoptions, step by step."""
    pair = Pair(skewed(flip_every=8, burst_every=12), pipeline=pipeline,
                cost_source=cost_source, ema_alpha=0.5)
    pair.run(32)
    pair.flush()
    pair.check()


# ---------------------------------------------------------------------------
# physics invariance: adoption must not change the served function
# ---------------------------------------------------------------------------


def test_adopted_permutation_preserves_moe_outputs():
    pair = Pair(skewed())
    x = TrafficGenerator(TrafficConfig(**skewed(seed=99))).batch(0)
    before = served(PARAMS, x)
    pair.run(20)
    pair.check()
    assert pair.port.lb_adoptions >= 1  # skew must actually trigger adoption
    assert not np.array_equal(pair.port.expert_placement(), np.arange(CFG.n_experts))
    after = served(pair.port.params, x)
    np.testing.assert_allclose(after, before, atol=1e-5)
    np.testing.assert_allclose(after, ref_served(pair.ref.params, x), atol=1e-5)


def test_external_apply_mapping_same_commit_path():
    pair = Pair(skewed())
    x = TrafficGenerator(TrafficConfig(**skewed(seed=98))).batch(0)
    before = served(pair.port.params, x)
    target = np.arange(CFG.n_experts)[::-1] // 2  # reversed blocks
    pair.ref.apply_mapping(target)
    pair.port.apply_mapping(target)
    np.testing.assert_array_equal(pair.port.balancer.mapping, target)
    pair.check()
    np.testing.assert_allclose(served(pair.port.params, x), before, atol=1e-5)
    with pytest.raises(ValueError):
        pair.port.apply_mapping(np.zeros(CFG.n_experts, np.int64))  # unequal counts
    with pytest.raises(ValueError):
        pair.port.apply_mapping(np.arange(CFG.n_experts))  # device 15 of 8
    with pytest.raises(ValueError):
        pair.port.apply_mapping(np.zeros(3, np.int64))


def test_adoptions_keep_equal_expert_blocks():
    pair = Pair(skewed(flip_every=8))
    pair.run(30)
    pair.check()
    rt = pair.port
    assert rt.lb_adoptions >= 1
    counts = np.bincount(rt.balancer.mapping, minlength=8)
    assert np.all(counts == CFG.n_experts // 8)
    assert sorted(rt.expert_placement().tolist()) == list(range(CFG.n_experts))


def test_permutation_for_mapping_matches_reference():
    slot = np.arange(4)
    with pytest.raises(ValueError):
        permutation_for_mapping(slot, np.array([0, 0, 0, 1]), 2)
    with pytest.raises(ValueError):
        permutation_for_mapping(np.arange(3), np.array([0, 1, 0]), 2)
    perm, new_slot = permutation_for_mapping(slot, np.array([1, 1, 0, 0]), 2)
    np.testing.assert_array_equal(new_slot, [2, 3, 0, 1])
    np.testing.assert_array_equal(perm, [2, 3, 0, 1])
    rng = np.random.default_rng(0)
    for _ in range(20):
        slot = rng.permutation(16)
        mapping = rng.permutation(np.arange(16) // 4)
        for got, want in zip(permutation_for_mapping(slot, mapping, 4),
                             ref_permutation_for_mapping(slot, mapping, 4)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the adoption gate: act on drift, refuse noise
# ---------------------------------------------------------------------------


def test_thrash_gate_holds_under_near_uniform_traffic():
    pair = Pair(uniform(), ema_alpha=0.5)
    pair.run(40)
    pair.check()
    assert pair.port.lb_adoptions <= 1
    assert pair.port.mean_efficiency() > 0.8  # it was already balanced
    assert pair.port.mean_efficiency() == pair.ref.mean_efficiency()
    assert pair.port.modeled_interval_time() == pair.ref.modeled_interval_time()


def test_hot_expert_flip_events_match_reference():
    """The drift case, held to the reference's own events (see the module
    docstring for why no adoption after the flip is asserted)."""
    flip, interval = 20, 5
    pair = Pair(skewed(flip_every=flip, night_load=1.0), lb_interval=interval)
    pair.run(2 * flip)
    pair.check()
    assert [e.step for e in pair.port.balancer.events] == list(range(0, 2 * flip, interval))


# ---------------------------------------------------------------------------
# straggler replica (seeded fault injection)
# ---------------------------------------------------------------------------


def _fault_time_fn(schedule):
    """Per-device interval times that ignore the wall clock: 1.0 each,
    times the magnitude of the faults the schedule fires this round."""
    rounds = {"n": 0}

    def time_fn(runtime, elapsed):
        times = np.ones(8)
        for f in schedule.take(rounds["n"]):
            times[f.device] *= f.magnitude
        rounds["n"] += 1
        return times

    return time_fn


def test_straggling_replica_loses_experts():
    pair = Pair(uniform(), ema_alpha=0.5)
    pair.ref.attach_straggler_detector(
        RefStragglerDetector(8, alpha=1.0),
        time_fn=_fault_time_fn(RefFaultSchedule(
            [RefFault("straggler_spike", interval=0, device=3, magnitude=4.0, repeats=99)])))
    pair.port.attach_straggler_detector(
        StragglerDetector(8, alpha=1.0),
        time_fn=_fault_time_fn(FaultSchedule(
            [Fault("straggler_spike", interval=0, device=3, magnitude=4.0, repeats=99)])))
    pair.run(25)
    pair.flush()
    pair.check()
    caps = pair.port.balancer.capacities
    assert caps is not None and caps[3] < caps.min(initial=2.0, where=np.arange(8) != 3)
    raw = device_loads(pair.port.slot_costs(), pair.port.balancer.mapping, 8)
    assert raw[3] < raw[np.arange(8) != 3].max()


def test_update_capacities_forces_rebalance():
    pair = Pair(uniform(), ema_alpha=0.5)
    pair.run(12)
    adoptions_before = pair.port.lb_adoptions
    caps = np.ones(8)
    caps[0] = 0.25  # device 0 suddenly quarter speed
    pair.ref.update_capacities(caps)
    pair.port.update_capacities(caps)
    pair.run(10)
    pair.check()
    assert pair.port.lb_adoptions > adoptions_before  # gate was bypassed once
    raw = device_loads(pair.port.slot_costs(), pair.port.balancer.mapping, 8)
    assert raw[0] < raw[1:].max()


# ---------------------------------------------------------------------------
# snapshot / restore across device counts
# ---------------------------------------------------------------------------


def test_snapshot_restores_across_device_counts():
    """A snapshot taken at 8 modelled devices restores onto 4, port to port
    and reference to port, as the reference's restores its own."""
    pair = Pair(skewed())
    pair.run(12)
    x = TrafficGenerator(TrafficConfig(**skewed(seed=97))).batch(0)
    before = served(pair.port.params, x)
    snap = pair.port.snapshot()
    ref_snap = pair.ref.snapshot()
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in snap["params"].values())

    ref_rt2 = RefRuntime(ref_init_moe(jax.random.PRNGKey(7), REF_CFG)[0], REF_CFG,
                         RefTrafficGenerator(RefTrafficConfig(**skewed())),
                         n_devices=4, lb_interval=5)
    ref_rt2.restore(ref_snap)
    other, _ = init_moe(7, CFG, device="cpu")
    for source in (snap, dict(ref_snap, params=params_from(ref_snap["params"], "cpu"))):
        rt2 = ExpertRuntime(other, CFG, TrafficGenerator(TrafficConfig(**skewed())),
                            n_devices=4, lb_interval=5, device="cpu")
        rt2.restore(source)
        assert_same_run(ref_rt2, rt2)
        np.testing.assert_allclose(served(rt2.params, x), before, atol=1e-5)
        assert rt2.step_idx == pair.port.step_idx
        assert rt2.tokens_served == pair.port.tokens_served
        counts = np.bincount(rt2.balancer.mapping, minlength=4)
        assert np.all(counts == CFG.n_experts // 4)
        assert rt2.lb_adoptions == 0  # restore is recovery, not adoption
        assert efficiency(rt2.slot_costs(), rt2.balancer.mapping, 4) >= efficiency(
            rt2.slot_costs(), np.arange(CFG.n_experts) // (CFG.n_experts // 4), 4
        ) - 1e-9


def test_restore_without_costs_keeps_committed_placement():
    pair = Pair(skewed())
    pair.run(12)
    assert pair.port.lb_adoptions >= 1
    snap, ref_snap = pair.port.snapshot(), pair.ref.snapshot()
    snap["balancer"], ref_snap["balancer"] = {}, {}  # the EWMA state did not survive
    pair2 = Pair(skewed(), lb_enabled=False)
    pair2.ref.restore(ref_snap)
    pair2.port.restore(snap)
    assert_same_run(pair2.ref, pair2.port)
    np.testing.assert_array_equal(pair2.port.balancer.mapping, snap["mapping"])
    np.testing.assert_array_equal(pair2.port.expert_placement(), pair.port.expert_placement())
    assert pair2.port.lb_adoptions == 0
    x = TrafficGenerator(TrafficConfig(**skewed(seed=96))).batch(0)
    np.testing.assert_allclose(served(pair2.port.params, x), served(pair.port.params, x),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the async interval pipeline (staleness contract)
# ---------------------------------------------------------------------------


def test_async_defers_harvest_by_one_interval_and_flush_drains():
    sync = Pair(skewed(), pipeline="sync")
    sync.run(6)  # boundaries at steps 0 and 5
    sync.check()
    assert sync.port.host_syncs == 2
    assert [s for s, _ in sync.port.efficiency_trace] == [0, 5]

    pair = Pair(skewed(), pipeline="async")
    rt = pair.port
    pair.run(1)  # first boundary: measurement goes in flight, nothing lands
    assert rt.host_syncs == 0 and rt.efficiency_trace == []
    pair.run(5)  # second boundary resolves the first measurement
    assert rt.host_syncs == 1
    assert [s for s, _ in rt.efficiency_trace] == [0]
    pair.flush()  # drains the in-flight round
    assert rt.host_syncs == 2
    assert [s for s, _ in rt.efficiency_trace] == [0, 5]
    pair.flush()  # idempotent
    assert rt.host_syncs == 2
    pair.check()


def test_async_matches_sync_measurements_one_interval_late():
    a = Pair(skewed(), pipeline="sync", lb_enabled=False)
    b = Pair(skewed(), pipeline="async", lb_enabled=False)
    a.run(11)
    b.run(11)
    b.flush()
    a.check()
    b.check()
    assert len(a.port.interval_loads) == len(b.port.interval_loads)
    for la, lb_ in zip(a.port.interval_loads, b.port.interval_loads):
        np.testing.assert_array_equal(la, lb_)


def test_async_matches_sync_measurements_under_adoptions():
    """A deferred measurement is decoded with the layout it accumulated
    under, though an adoption landed at the boundary between."""
    kw = dict(improvement_threshold=0.0, ema_alpha=0.5)
    a = Pair(skewed(flip_every=8), pipeline="sync", **kw)
    b = Pair(skewed(flip_every=8), pipeline="async", **kw)
    a.run(26)
    b.run(26)
    b.flush()
    a.check()
    b.check()
    assert a.port.lb_adoptions >= 2  # the layout really changed mid-run
    assert b.port.lb_adoptions >= 2
    assert len(a.port.interval_costs) == len(b.port.interval_costs)
    for ca, cb in zip(a.port.interval_costs, b.port.interval_costs):
        np.testing.assert_array_equal(ca, cb)


def test_invalid_construction_rejected():
    traffic = TrafficGenerator(TrafficConfig(**skewed()))
    for kw in (dict(n_devices=3), dict(n_devices=8, cost_source="vibes"),
               dict(n_devices=8, pipeline="warp")):
        with pytest.raises(ValueError):
            ExpertRuntime(PARAMS, CFG, traffic, device="cpu", **kw)
    with pytest.raises(ValueError):
        ExpertRuntime(PARAMS, CFG.scaled(n_experts=0), traffic, n_devices=1, device="cpu")


def test_cost_source_heuristic_also_balances():
    pair = Pair(skewed(), cost_source="heuristic")
    pair.run(20)
    pair.check()
    assert pair.port.lb_adoptions >= 1


def test_static_mode_balances_once_then_freezes():
    """``static=True`` balances at the first boundary and never again; the
    intervals are still measured."""
    pair = Pair(skewed(flip_every=8), static=True)
    pair.run(30)
    pair.check()
    assert pair.port.lb_adoptions <= 1
    assert len(pair.port.efficiency_trace) == 6
