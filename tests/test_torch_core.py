"""The port's copy of the balancer core against ``repro.core``.

On the same seeded cost sequences the two must record identical events:
steps, adoption decisions, efficiencies and mappings (exact — both are the
same float64 numpy arithmetic).
"""
import numpy as np
import pytest

from repro import core as jcore

from repro_torch import core as tcore


def _cost_rounds(seed, n_boxes, n_rounds):
    rng = np.random.default_rng(seed)
    base = rng.lognormal(0.0, 1.0, n_boxes)
    for _ in range(n_rounds):
        base = base * rng.lognormal(0.0, 0.3, n_boxes)  # drifting hotspot
        yield base.copy()


@pytest.mark.parametrize("policy", ["knapsack", "sfc"])
@pytest.mark.parametrize("ema_alpha", [1.0, 0.5])
def test_balancer_events_match(policy, ema_alpha):
    n_boxes, n_dev = 36, 4
    coords = np.stack(np.divmod(np.arange(n_boxes), 6), axis=1)
    kw = dict(n_devices=n_dev, policy=policy, interval=2, ema_alpha=ema_alpha)
    jb, tb = jcore.LoadBalancer(**kw), tcore.LoadBalancer(**kw)
    bytes_ = np.linspace(1.0, 2.0, n_boxes)
    for step, costs in enumerate(_cost_rounds(7, n_boxes, 16)):
        rj = jb.step(step, costs, box_coords=coords, box_bytes=bytes_)
        rt = tb.step(step, costs, box_coords=coords, box_bytes=bytes_)
        assert (rj is None) == (rt is None)
        np.testing.assert_array_equal(tb.mapping, jb.mapping)
    assert any(e.adopted for e in jb.events)
    assert [tuple(vars(e).values()) for e in tb.events] == [
        tuple(vars(e).values()) for e in jb.events
    ]


def test_cost_measures_and_virtual_cluster_match():
    rng = np.random.default_rng(3)
    n = rng.integers(0, 1000, 16).astype(np.float64)
    cells = np.full(16, 64.0)
    np.testing.assert_array_equal(
        tcore.HeuristicCost().measure(n_particles=n, n_cells=cells),
        jcore.HeuristicCost().measure(n_particles=n, n_cells=cells),
    )
    costs = rng.uniform(1, 2, (5, 16))
    mapping = tcore.round_robin_mapping(16, 4)
    nbrs = [[(b + 1) % 16] for b in range(16)]
    surf = np.full(16, 8.0)
    jv, tv = jcore.VirtualCluster(4), tcore.VirtualCluster(4)
    rj = jv.record_interval(0, costs, mapping, neighbors=nbrs, surface_bytes=surf, lb_called=True)
    rt = tv.record_interval(0, costs, mapping, neighbors=nbrs, surface_bytes=surf, lb_called=True)
    assert [tuple(vars(r).values()) for r in rt] == [tuple(vars(r).values()) for r in rj]


def test_knapsack_loses_to_round_robin_on_a_known_input():
    """The reference's LPT knapsack (``max_boxes_per_device=None``) can do
    worse than the cost-oblivious round robin, against what
    ``tests/test_core_policies.py::test_knapsack_beats_round_robin``
    asserts for every draw: on these 22 boxes over 2 devices it reaches
    an efficiency of 0.985569 where round robin reaches 0.999973.  The
    port's mapping is the reference's, so the port keeps the defect."""
    costs = np.array([0, 251493, 0, 229410, 923239, 621683, 0, 0, 279730, 840609, 0, 0, 0, 81876, 0, 0,
                      536423, 133873, 419667, 0, 0, 0], dtype=np.float64)
    ref = jcore.knapsack_partition(costs, 2, max_boxes_per_device=None)
    port = tcore.knapsack_partition(costs, 2, max_boxes_per_device=None)
    np.testing.assert_array_equal(port, ref)
    rr = tcore.round_robin_mapping(len(costs), 2)
    np.testing.assert_array_equal(rr, jcore.round_robin_mapping(len(costs), 2))
    for eff in (jcore.efficiency, tcore.efficiency):
        assert abs(eff(costs, port, 2) - 0.985569) < 1e-6
        assert abs(eff(costs, rr, 2) - 0.999973) < 1e-6
