"""The port's collectives over logical CPU devices against "all-gather,
then slice" (the reference's own oracle, ``tests/test_collectives.py``).

A logical device is one entry of the per-device lists; on the CPU they all
live on ``cpu``, as logical devices may share one card on the GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.dist.collectives import neighbor_exchange, neighbor_reduce, ring_all_gather

N_DEVICES = [1, 2, 4, 8]


def _shards(n, rows=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((rows, 5), generator=g) for _ in range(n)]


@pytest.mark.parametrize("n", N_DEVICES)
def test_ring_all_gather_is_the_global_array(n):
    shards = _shards(n)
    full = torch.cat(shards)
    out = ring_all_gather(shards)
    assert len(out) == n
    for d in range(n):
        assert torch.equal(out[d], full)
        assert out[d].device == shards[d].device


def _offsets(n):
    return sorted({0, 1 % n, (n - 1) % n, (n // 2) % n})


@pytest.mark.parametrize("n", N_DEVICES)
def test_neighbor_exchange_is_gather_then_slice(n):
    shards = _shards(n, seed=1)
    offsets = _offsets(n)
    # device d sends shards[d] + o on offset o, plus an int tag
    payloads = [
        {o: (shards[d] + o, {"tag": torch.full((2,), d * 100 + o)}) for o in offsets}
        for d in range(n)
    ]
    arrivals = neighbor_exchange(payloads)
    everything = torch.stack(shards)  # the all-gather
    for r in range(n):
        assert sorted(arrivals[r]) == offsets
        for o in offsets:
            src = (r - o) % n
            vals, meta = arrivals[r][o]
            assert torch.equal(vals, everything[src] + o)
            assert meta["tag"].tolist() == [src * 100 + o] * 2


@pytest.mark.parametrize("n", N_DEVICES)
def test_neighbor_exchange_offset_zero_passes_through(n):
    payloads = [{0: torch.full((4,), float(d))} for d in range(n)]
    arrivals = neighbor_exchange(payloads)
    for d in range(n):
        assert arrivals[d][0] is payloads[d][0]


def test_neighbor_exchange_needs_uniform_offsets():
    payloads = [{1: torch.zeros(2)}, {}]
    with pytest.raises(ValueError, match="offset"):
        neighbor_exchange(payloads)


@pytest.mark.parametrize("n", N_DEVICES)
def test_neighbor_reduce_folds_in_ascending_offset_order(n):
    offsets = _offsets(n)
    rng = np.random.default_rng(n)
    vals = rng.standard_normal((n, max(offsets) + 1, 6)).astype(np.float32)
    payloads = [
        {o: torch.from_numpy(vals[d, o]) for o in reversed(offsets)} for d in range(n)
    ]
    seen = []

    def fold(acc, o, arrival, d):
        seen.append((d, o))
        return acc + arrival * (o + 1)

    init = [torch.zeros(6) for _ in range(n)]
    out = neighbor_reduce(init, payloads, fold)
    for d in range(n):
        assert [o for dd, o in seen if dd == d] == offsets
        # the reference fold order, accumulated in float32 the same way
        expect = np.zeros(6, np.float32)
        for o in offsets:
            expect = expect + vals[(d - o) % n, o] * np.float32(o + 1)
        np.testing.assert_array_equal(out[d].numpy(), expect)
