"""Collectives over logical devices (counterpart of
``repro.dist.collectives``).

The reference runs them inside one ``shard_map`` program, one
``ppermute`` per ring hop.  The port is single-controller too, but without
a compiler in between: a collective takes one value per logical device (a
list indexed by ring position) and moves each tensor with
``Tensor.to(dst, non_blocking=True)``.  When source and destination are the
same card that is no copy at all; between two GPUs of one node it is a peer
copy on the current stream.  Nothing here waits for the device.

  * :func:`ring_all_gather` — the reference path (``comm="ring"``): every
    device ends up with every shard, in device order.
  * :func:`neighbor_exchange` / :func:`neighbor_reduce` — the locality-aware
    path (``comm="neighbor"``): each device sends one payload per ring
    offset; offset ``o`` carries device ``d``'s payload to device
    ``(d + o) % n``.
  * :func:`neighbor_exchange_start` / :func:`neighbor_exchange_done` — the
    same exchange split into issue and finish, so the caller can issue work
    that does not depend on it (split-phase stepping's interior deposit)
    in between.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

__all__ = [
    "ring_all_gather",
    "neighbor_exchange",
    "neighbor_reduce",
    "NeighborExchangeHandle",
    "neighbor_exchange_start",
    "neighbor_exchange_done",
]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"payload leaves must be tensors, got {type(tree).__name__}")


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        return _first_leaf(v)
    raise ValueError("empty payload")


def ring_all_gather(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather the leading axis: ``shards[d]`` is device ``d``'s
    ``(chunk, ...)`` shard; returns, for every device, the ``(n * chunk,
    ...)`` concatenation in device order, on that device.  Devices that
    share a card share one concatenation (treat the results as read-only)."""
    shards = list(shards)
    by_device: Dict[torch.device, torch.Tensor] = {}
    out = []
    for s in shards:
        dev = s.device
        if dev not in by_device:
            by_device[dev] = torch.cat([t.to(dev, non_blocking=True) for t in shards])
        out.append(by_device[dev])
    return out


def neighbor_exchange(payloads_by_device: Sequence[Dict[int, object]]) -> List[Dict[int, object]]:
    """Exchange per-offset payloads around the ring.

    ``payloads_by_device[d][o]`` is the pytree (tensors in tuples, lists or
    dicts) device ``d`` addresses to device ``(d + o) % n``.  Every device
    supplies the same offset keys, as in the reference's one ``ppermute``
    per offset.  Returns ``arrivals`` with ``arrivals[r][o]`` the payload
    device ``(r - o) % n`` sent, moved to the device of ``r``'s own payload
    for ``o``.  Offset 0 passes through untouched.
    """
    n = len(payloads_by_device)
    arrivals: List[Dict[int, object]] = [{} for _ in range(n)]
    for r in range(n):
        for o in payloads_by_device[r]:
            src = (r - o) % n
            if o not in payloads_by_device[src]:
                raise ValueError(f"device {src} sends nothing on offset {o}")
            tree = payloads_by_device[src][o]
            if o % n == 0:
                arrivals[r][o] = tree
                continue
            dst = _first_leaf(payloads_by_device[r][o]).device
            arrivals[r][o] = _tree_map(lambda a: a.to(dst, non_blocking=True), tree)
    return arrivals


def neighbor_reduce(
    init: Sequence, payloads_by_device: Sequence[Dict[int, object]], fold_fn: Callable
) -> List:
    """:func:`neighbor_exchange`, folding each device's arrivals into its
    ``init[d]`` with ``fold_fn(acc, offset, arrival, d) -> acc`` in
    ascending offset order, so the floating-point accumulation order is the
    reference's."""
    arrivals = neighbor_exchange(payloads_by_device)
    out = []
    for d, acc in enumerate(init):
        for o in sorted(arrivals[d]):
            acc = fold_fn(acc, o, arrivals[d][o], d)
        out.append(acc)
    return out


class NeighborExchangeHandle:
    """An issued neighbour exchange: the arrivals of every device, whose
    copies are queued on the stream.  Work issued between
    :func:`neighbor_exchange_start` and :func:`neighbor_exchange_done` that
    does not read them is independent of the exchange."""

    __slots__ = ("arrivals",)

    def __init__(self, arrivals: List[Dict[int, object]]):
        self.arrivals = arrivals


def neighbor_exchange_start(payloads_by_device: Sequence[Dict[int, object]]) -> NeighborExchangeHandle:
    """Issue the directional copies of :func:`neighbor_exchange` (the same
    contract) and return at once; nothing waits.  The reference also pins
    the phase boundary with an XLA optimization barrier; eager PyTorch
    issues in program order, so the interior work issued next already sits
    between the copies and :func:`neighbor_exchange_done`."""
    return NeighborExchangeHandle(neighbor_exchange(payloads_by_device))


def neighbor_exchange_done(handle: NeighborExchangeHandle) -> List[Dict[int, object]]:
    """Finish a :func:`neighbor_exchange_start`: ``arrivals[r][o]`` is the
    payload device ``(r - o) % n`` addressed to device ``r``.  Stream order
    makes the copies complete before any later use of them."""
    return handle.arrivals
