"""The port's traffic generator and ``RequestBalancer`` against the
reference's, and the serving properties drawn through both packages
(counterparts of ``tests/test_serving_dlb.py`` and
``tests/test_serving_properties.py``).

Exact: every traffic draw (``batch``, ``topic_weights``, ``load``,
``hot_topic``, ``request_lengths``, ``bucket_costs``, ``trace``) bit for
bit, the request balancer's mapping sequence, and in the properties the
port's balancer events and mappings; the served function within atol 1e-5.
Each hypothesis property keeps the reference's ``max_examples`` and runs
every example through both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models.common import ModelConfig as RefConfig
from repro.models.moe import apply_expert_permutation as ref_permute
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe as ref_moe
from repro.serve import ExpertRuntime as RefRuntime
from repro.serve import TrafficConfig as RefTrafficConfig
from repro.serve import TrafficGenerator as RefTrafficGenerator
from repro.train.servestep import RequestBalancer as RefRequestBalancer
from repro_torch.convert import params_from
from repro_torch.core import efficiency, round_robin_mapping
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import apply_expert_permutation, moe
from repro_torch.serve import ExpertRuntime, TrafficConfig, TrafficGenerator
from repro_torch.train.servestep import RequestBalancer

TRAFFIC_CASES = {
    "default": dict(seed=0),
    "flip-burst": dict(seed=5, flip_every=7, burst_every=11),
    "dense-requests": dict(seed=11, request_rate=48.0, long_frac=0.3),
    "skewed-night": dict(seed=9, d_model=48, batch=3, seq=8, n_topics=5, skew=2.5,
                         period=24, night_load=0.3, flip_every=5, burst_every=8, noise=0.5),
    "scout-width": dict(seed=7, d_model=5120, batch=1, seq=4, n_topics=16, skew=2.5,
                        night_load=1.0, flip_every=15),
}


def _pair(kw):
    return RefTrafficGenerator(RefTrafficConfig(**kw)), TrafficGenerator(TrafficConfig(**kw))


# -- traffic: bitwise the reference's ------------------------------------


@pytest.mark.parametrize("case", list(TRAFFIC_CASES))
def test_traffic_draws_are_the_references_bit_for_bit(case):
    ref, port = _pair(TRAFFIC_CASES[case])
    np.testing.assert_array_equal(port.topic_vecs, ref.topic_vecs)
    for step in (0, 1, 3, 7, 8, 15, 16, 30, 47, 64):
        assert port.load(step) == ref.load(step)
        assert port.hot_topic(step) == ref.hot_topic(step)
        np.testing.assert_array_equal(port.topic_weights(step), ref.topic_weights(step))
        got, want = port.request_lengths(step), ref.request_lengths(step)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for n_buckets in (1, 4, 16):
            np.testing.assert_array_equal(port.bucket_costs(step, n_buckets),
                                          ref.bucket_costs(step, n_buckets))
    for step in (0, 5, 13):
        got, want = port.batch(step), ref.batch(step)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for key, value in ref.trace(20).items():
        np.testing.assert_array_equal(port.trace(20)[key], value)


def test_traffic_config_fields_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TrafficConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(RefTrafficConfig)
    ]
    with pytest.raises(ValueError):
        TrafficGenerator(TrafficConfig(n_topics=0))
    with pytest.raises(ValueError):
        TrafficGenerator(TrafficConfig(night_load=0.0))
    with pytest.raises(ValueError):
        TrafficGenerator(TrafficConfig()).bucket_costs(0, 0)


def test_traffic_is_call_order_independent():
    cfg = TrafficConfig(seed=9, flip_every=5, burst_every=8)
    a, b = TrafficGenerator(cfg), TrafficGenerator(cfg)
    xa = [a.batch(s) for s in (3, 0, 7)]
    _ = b.request_lengths(2)  # interleave unrelated draws
    xb = [b.batch(s) for s in (7, 3, 0)]
    np.testing.assert_array_equal(xa[0], xb[1])
    np.testing.assert_array_equal(xa[1], xb[2])
    np.testing.assert_array_equal(xa[2], xb[0])


def test_traffic_hot_topic_flips_and_load_bounds():
    gen = TrafficGenerator(TrafficConfig(seed=3, skew=2.0, flip_every=10,
                                         night_load=1.0, burst_every=0))
    assert gen.hot_topic(0) != gen.hot_topic(10)
    assert gen.hot_topic(0) == gen.hot_topic(9)
    cfg = TrafficConfig(seed=0, period=24, night_load=0.3)
    loads = np.array([TrafficGenerator(cfg).load(s) for s in range(3 * cfg.period)])
    assert loads.min() >= cfg.night_load - 1e-12 and loads.max() <= 1.0 + 1e-12
    assert loads.max() - loads.min() > 0.5


# -- the request balancer -----------------------------------------------


def _assign_both(n_replicas, interval, rounds, threshold=0.10):
    ref = RefRequestBalancer(n_replicas=n_replicas, interval=interval, threshold=threshold)
    port = RequestBalancer(n_replicas=n_replicas, interval=interval, threshold=threshold)
    out = []
    for step, costs in enumerate(rounds):
        m_ref = ref.assign(step, costs).copy()
        m_port = port.assign(step, costs).copy()
        np.testing.assert_array_equal(m_port, m_ref)
        out.append(m_port)
    assert [dataclasses.astuple(e) for e in port.lb.events] == [
        dataclasses.astuple(e) for e in ref.lb.events
    ]
    return out


def test_request_balancer_balances_skewed_buckets():
    costs = np.array([10.0, 10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0] * 2)
    (mapping,) = _assign_both(4, 1, [costs])
    assert efficiency(costs, mapping, 4) > 0.9


def test_request_balancer_gate_prevents_thrash():
    rng = np.random.default_rng(0)
    costs = rng.uniform(1.0, 2.0, 16)
    m0, m1 = _assign_both(4, 1, [costs, costs * rng.uniform(0.98, 1.02, 16)])
    np.testing.assert_array_equal(m0, m1)


@pytest.mark.parametrize("interval", [1, 3])
def test_traffic_buckets_feed_the_request_balancer(interval):
    """The mapping sequence over a 20-step trace is the reference's, and
    the balanced trace is no worse than round robin overall."""
    gen = TrafficGenerator(TrafficConfig(seed=11, request_rate=48.0, long_frac=0.3))
    rounds = [gen.bucket_costs(step, n_buckets=16) for step in range(20)]
    mappings = _assign_both(4, interval, rounds)
    e_lb = sum(efficiency(c, m, 4) for c, m in zip(rounds, mappings))
    e_rr = sum(efficiency(c, round_robin_mapping(16, 4), 4) for c in rounds)
    assert e_lb >= e_rr
    if interval == 1:
        assert e_lb / 20 > 0.6


# -- the hypothesis properties, through both packages -------------------

_TOY = dict(
    name="prop-toy", kind="moe", n_layers=1, d_model=16, n_heads=2,
    n_kv_heads=2, head_dim=8, d_ff=32, vocab=64, n_experts=8, top_k=2,
)
_REF_CFG = RefConfig(**_TOY, param_dtype=jnp.float32)
_CFG = ModelConfig(**_TOY, param_dtype=torch.float32)
_REF_PARAMS, _ = ref_init_moe(jax.random.PRNGKey(0), _REF_CFG)
_PARAMS = params_from(jax.tree.map(np.asarray, _REF_PARAMS), "cpu")


def _runtimes(tc: dict, **kw):
    ref = RefRuntime(_REF_PARAMS, _REF_CFG, RefTrafficGenerator(RefTrafficConfig(**tc)), **kw)
    port = ExpertRuntime(_PARAMS, _CFG, TrafficGenerator(TrafficConfig(**tc)),
                         device="cpu", **kw)
    return ref, port


def _same_lb(ref, port):
    assert [dataclasses.astuple(e) for e in port.balancer.events] == [
        dataclasses.astuple(e) for e in ref.balancer.events
    ]
    np.testing.assert_array_equal(port.balancer.mapping, ref.balancer.mapping)
    np.testing.assert_array_equal(port.expert_placement(), ref.expert_placement())


@given(
    st.lists(st.floats(0.1, 100.0, allow_nan=False), min_size=4, max_size=40),
    st.integers(2, 8),
)
@settings(max_examples=50, deadline=None)
def test_request_balancer_never_worse_than_round_robin(costs, n_replicas):
    costs = np.asarray(costs)
    (mapping,) = _assign_both(n_replicas, 1, [costs])
    rr = round_robin_mapping(len(costs), n_replicas)
    assert efficiency(costs, mapping, n_replicas) >= efficiency(costs, rr, n_replicas) - 1e-9


@given(
    seed=st.integers(0, 2**16),
    skew=st.floats(0.0, 3.0, allow_nan=False),
    n_topics=st.integers(2, 8),
)
@settings(max_examples=15, deadline=None)
def test_one_dlb_round_never_worse_than_starting_placement(seed, skew, n_topics):
    tc = dict(seed=seed, d_model=_CFG.d_model, batch=1, seq=16,
              n_topics=n_topics, skew=skew, flip_every=3, burst_every=4)
    ref, port = _runtimes(tc, n_devices=4, lb_interval=100)
    start = port.balancer.mapping.copy()
    ref.run(1)
    port.run(1)  # exactly the step-0 boundary round
    _same_lb(ref, port)
    costs = port.slot_costs()
    assert costs is not None
    np.testing.assert_array_equal(costs, ref.slot_costs())
    assert efficiency(costs, port.balancer.mapping, 4) >= efficiency(costs, start, 4) - 1e-9


@given(
    seed=st.integers(0, 2**16),
    skew=st.floats(0.0, 3.0, allow_nan=False),
)
@settings(max_examples=10, deadline=None)
def test_gate_never_adopts_a_non_improvement(seed, skew):
    tc = dict(seed=seed, d_model=_CFG.d_model, batch=1, seq=16,
              n_topics=4, skew=skew, flip_every=3, burst_every=4)
    ref, port = _runtimes(tc, n_devices=4, lb_interval=2)
    ref.run(8)
    port.run(8)
    _same_lb(ref, port)
    assert port.balancer.events, "LB rounds must have run"
    for e in port.balancer.events:
        if e.adopted:
            assert e.proposed_efficiency >= e.current_efficiency


@given(perm=st.permutations(list(range(_CFG.n_experts))))
@settings(max_examples=15, deadline=None)
def test_moe_invariant_under_any_expert_permutation(perm):
    x = np.random.default_rng(0).standard_normal((1, 8, _CFG.d_model)).astype(np.float32)
    perm = np.asarray(perm)
    base = moe(_PARAMS, _CFG, torch.from_numpy(x))[0].numpy()
    out = moe(apply_expert_permutation(_PARAMS, perm), _CFG, torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(out, base, atol=1e-5)
    ref_out = np.asarray(ref_moe(ref_permute(_REF_PARAMS, perm), _REF_CFG, jnp.asarray(x))[0])
    np.testing.assert_allclose(out, ref_out, atol=1e-5)
