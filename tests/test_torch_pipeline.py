"""The port's ``IntervalPipeline`` and ``ShardedRuntime(pipeline="async")``
on the CPU.

Pipeline: the counterparts of ``tests/test_step_fusion.py``'s pipeline tests
(depth 1 is the serial loop; rounds come back in issue order under their own
metadata; a correction lands between rounds; a failed correction surfaces
at the next call), and a seeded sequence of enqueues, corrections and
harvests run through both packages' pipelines with the same results.

Runtime: async against the reference's async runtime on one device (the
exact keys of ``test_torch_sharded.assert_matches``, fields and particles
within 2e-5·max|ref|), and the counterparts of
``tests/test_sharded_runtime.py``'s async tests: async physics equals sync,
one sync per interval with one round pending between ``run`` calls, the
dispatch count, and an adoption landing exactly one interval late (on two
logical devices; the same contract is held against the reference on 2 and
4 devices in ``test_torch_sharded_multi.py``).
"""
import numpy as np
import pytest
import torch

import test_torch_sharded as oracle
from repro_torch.dist import ShardedRuntime
from repro_torch.pic import laser_ion_problem
from repro_torch.pic.engine import IntervalPipeline


def _counter_program(state, inc):
    """Toy interval program: state' = state + inc, history = state'."""
    new = state + inc
    return new, new


def test_interval_pipeline_depth1_is_the_serial_reference():
    pipe = IntervalPipeline(torch.tensor(0.0), depth=1)
    pipe.enqueue(_counter_program, 1.0, meta="a")
    assert pipe.full
    host, meta = pipe.harvest()
    assert (float(host), meta) == (1.0, "a")
    assert isinstance(host, np.ndarray)
    with pytest.raises(ValueError):
        IntervalPipeline(torch.tensor(0.0), depth=0)


def test_interval_pipeline_rotates_and_orders_rounds():
    pipe = IntervalPipeline(torch.tensor(0.0), depth=2)
    pipe.enqueue(_counter_program, 1.0, meta={"round": 0})
    pipe.enqueue(_counter_program, 10.0, meta={"round": 1})
    assert pipe.pending == 2 and pipe.full
    with pytest.raises(RuntimeError, match="full"):
        pipe.enqueue(_counter_program, 99.0)
    h0, m0 = pipe.harvest()
    h1, m1 = pipe.harvest()
    assert (float(h0), m0["round"]) == (1.0, 0)
    assert (float(h1), m1["round"]) == (11.0, 1)
    assert pipe.harvest() is None
    assert float(pipe.state) == 11.0
    assert pipe.harvests == 2


def test_interval_pipeline_correct_lands_between_rounds():
    pipe = IntervalPipeline(torch.tensor(0.0), depth=2)
    pipe.enqueue(_counter_program, 1.0)  # k: 0 -> 1 (in flight)
    pipe.correct(lambda s: s * 100.0)  # lands on k's output
    pipe.enqueue(_counter_program, 1.0)  # k+1: 100 -> 101
    assert float(pipe.harvest()[0]) == 1.0  # k's history: before the correction
    assert float(pipe.harvest()[0]) == 101.0
    assert pipe.host_blocked_s >= 0.0 and pipe.overlapped_host_s >= 0.0


def test_history_is_a_copy_taken_at_issue():
    """In-place work on the state after a round was issued (the kernels
    update particles in place) does not reach that round's history."""
    def program(state, inc):
        state.add_(inc)
        return state, state

    pipe = IntervalPipeline(torch.zeros(3), depth=2)
    pipe.enqueue(program, 1.0)
    pipe.enqueue(program, 1.0)
    np.testing.assert_array_equal(pipe.harvest()[0], np.ones(3))
    np.testing.assert_array_equal(pipe.harvest()[0], np.full(3, 2.0))


def test_interval_pipeline_surfaces_correction_failures_and_closes():
    pipe = IntervalPipeline(torch.tensor(0.0), depth=2)
    pipe.enqueue(_counter_program, 1.0)

    def boom(state):
        raise ValueError("bad permutation")

    pipe.correct(boom)
    with pytest.raises(RuntimeError, match="correction failed"):
        pipe.enqueue(_counter_program, 1.0)
    # the failed correction left the state chain untouched
    assert float(pipe.state) == 1.0
    pipe.enqueue(_counter_program, 1.0)
    assert [float(pipe.harvest()[0]) for _ in range(2)] == [1.0, 2.0]
    pipe.close()
    assert pipe.pending == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_interval_pipeline_matches_reference(depth):
    """A seeded sequence of enqueues, corrections and harvests through the
    reference's pipeline and the port's: the same histories, metadata and
    final state."""
    import jax.numpy as jnp

    from repro.pic.engine import IntervalPipeline as JPipeline

    rng = np.random.default_rng(depth)
    ops = []
    for i in range(40):
        r = rng.random()
        ops.append(("enqueue", float(rng.integers(1, 9)), i) if r < 0.5 else
                   ("correct", float(rng.integers(2, 4))) if r < 0.7 else ("harvest",))

    def play(pipe, scalar):
        out = []

        def harvest():
            got = pipe.harvest()
            out.append(None if got is None else (float(np.asarray(got[0])), got[1]))

        for op in ops:
            if op[0] == "enqueue":
                if pipe.full:
                    harvest()
                pipe.enqueue(lambda s, inc: (s + scalar(inc),) * 2, op[1], meta=op[2])
            elif op[0] == "correct":
                pipe.correct(lambda s, f: s * scalar(f), op[1])
            else:
                harvest()
        while pipe.pending:
            harvest()
        return out, float(np.asarray(pipe.state))

    ref = JPipeline(jnp.float32(0.0), depth=depth)
    want = play(ref, jnp.float32)
    ref.close()
    got = play(IntervalPipeline(torch.tensor(0.0), depth=depth), lambda v: torch.tensor(v))
    assert got == want


# ---------------------------------------------------------------------------
# ShardedRuntime(pipeline="async")
# ---------------------------------------------------------------------------


def _problem():
    return laser_ion_problem(**oracle.PROBLEM, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_async_single_device_matches_reference(comm, backend):
    kw = dict(comm=comm, lb_interval=4, pipeline="async")
    if backend == "cuda":
        kw["improvement_threshold"] = 10.0
    spec = ("laser", 1, kw, [("run", 6), ("run", 6)])
    oracle.assert_matches(oracle.port(spec, backend), oracle.reference(spec))


def _async_vs_sync(n_devices, n_steps=6, lb_interval=2):
    rts = {}
    for pipeline in ("sync", "async"):
        rt = ShardedRuntime(_problem(), n_devices, lb_interval=lb_interval,
                            pipeline=pipeline, device="cpu")
        n0 = rt.total_alive()
        rt.run(n_steps)
        rt.flush()
        assert rt.total_alive() == n0 and rt.dropped_total == 0
        assert rt.host_syncs == n_steps // lb_interval
        rts[pipeline] = rt
    f_sync = np.stack([np.asarray(c) for c in rts["sync"].fields])
    f_async = np.stack([np.asarray(c) for c in rts["async"].fields])
    assert np.abs(f_sync - f_async).max() <= 2e-5 * max(float(np.abs(f_sync).max()), 1e-30)
    np.testing.assert_allclose(rts["async"].history["field_energy"],
                               rts["sync"].history["field_energy"], rtol=oracle.FE_RTOL)
    return rts


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_async_matches_sync_physics(n_devices):
    _async_vs_sync(n_devices)


def test_async_sync_count_and_dispatches_under_pipelining():
    rt = ShardedRuntime(_problem(), 1, lb_interval=3, pipeline="async", device="cpu")
    base = rt.host_dispatches
    rt.run(9)  # three aligned intervals
    stats = rt.pipeline_stats()
    assert stats["pending"] == 1 and stats["depth"] == 2
    assert rt.host_syncs == 2
    rt.flush()
    assert rt.host_syncs == 3 and rt.pipeline_stats()["pending"] == 0
    adoptions = sum(e.adopted for e in rt.balancer.events)
    assert rt.host_dispatches - base == 3 + 2 * adoptions
    rt.flush()
    assert rt.host_syncs == 3


def test_async_hides_the_balancer_turnaround():
    """Under async the host's work after a harvest (bookkeeping, balancer)
    happens while a round is in flight; under sync only the few lines
    between an enqueue and its harvest do."""
    stats = {}
    for pipeline in ("sync", "async"):
        rt = ShardedRuntime(_problem(), 2, lb_interval=2, pipeline=pipeline, device="cpu")
        rt.run(6)
        stats[pipeline] = rt.pipeline_stats()
    assert stats["async"]["overlapped_host_s"] > stats["sync"]["overlapped_host_s"]
    for s in stats.values():
        assert s["host_blocked_s"] > 0.0 and s["harvests"] == s["host_syncs"]


def test_async_adoption_lands_exactly_one_interval_late():
    caps = np.array([1.0, 0.25])
    sync = ShardedRuntime(_problem(), 2, lb_interval=2, device="cpu")
    sync.update_capacities(caps)
    m0_sync = sync.balancer.mapping.copy()
    sync.run(2)
    assert (sync.balancer.mapping != m0_sync).any()

    rt = ShardedRuntime(_problem(), 2, lb_interval=2, pipeline="async", device="cpu")
    n0 = rt.total_alive()
    rt.update_capacities(caps)
    m0 = rt.balancer.mapping.copy()
    rt.run(2)  # round 0 issued; its counters still in flight
    assert (rt.balancer.mapping == m0).all()
    rt.run(2)  # round 1 issued, round 0 harvested: the adoption lands
    assert rt.pipeline_stats()["pending"] == 1
    np.testing.assert_array_equal(rt.balancer.mapping, sync.balancer.mapping)
    assert rt.history["lb_steps"] == [0]
    assert rt.total_alive() == n0
    rt.run(3)
    assert rt.total_alive() == n0 and rt.dropped_total == 0


def test_async_snapshot_is_the_committed_cut():
    """snapshot() flushes: nothing is in flight afterwards, and the async
    snapshot equals the sync one at the same step."""
    snaps = {}
    for pipeline in ("sync", "async"):
        rt = ShardedRuntime(_problem(), 1, lb_interval=2, pipeline=pipeline, device="cpu")
        rt.run(4)
        snaps[pipeline] = rt.snapshot()
        assert rt.pipeline_stats()["pending"] == 0
    a, b = snaps["sync"], snaps["async"]
    assert int(a["step_idx"]) == int(b["step_idx"]) == 4
    np.testing.assert_array_equal(a["tiles"], b["tiles"])
    for sa, sb in zip(a["species"], b["species"]):
        for k in oracle.PARTICLE_KEYS:
            np.testing.assert_array_equal(sa[k], sb[k])
