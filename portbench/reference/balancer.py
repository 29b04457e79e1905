"""The paper's balancer decision in plain NumPy (a frozen copy of the
knapsack the program runs, independent of it).

Each LB round offers per-box costs; the knapsack (greedy LPT, then
pairwise-swap refinement, with a cap of ``max_boxes`` × the average boxes
per device) proposes a mapping, and it is adopted only when its efficiency
(mean over max device load, paper Eq. 1) beats the current mapping's by
more than the threshold.  The sharded runtime holds every device at the
same box count (cap 1.0) and then swaps boxes back to within one ring hop
of their home on the Morton curve.

:func:`replay` follows a run round by round from the costs the program's
balancer was offered, and reports each round's adoption and mapping.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["knapsack", "efficiency", "round_robin", "morton_home", "locality_repair", "replay"]


def loads(costs: np.ndarray, mapping: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, np.float64)
    np.add.at(out, mapping, costs)
    return out


def efficiency(costs: np.ndarray, mapping: np.ndarray, n: int) -> float:
    ld = loads(costs, mapping, n)
    top = float(ld.max()) if len(ld) else 0.0
    return 1.0 if top <= 0.0 else float(ld.mean()) / top


def round_robin(n_boxes: int, n: int) -> np.ndarray:
    return np.arange(n_boxes, dtype=np.int64) % n


def knapsack(costs: np.ndarray, n: int, max_boxes: Optional[float], sweeps: int = 4) -> np.ndarray:
    costs = np.asarray(costs, np.float64)
    n_boxes = len(costs)
    cap = n_boxes if max_boxes is None else max(1, int(np.ceil(max_boxes * n_boxes / n)))
    mapping = np.empty(n_boxes, np.int64)
    heap = [(0.0, 0, d) for d in range(n)]
    heapq.heapify(heap)
    parked = []
    for b in np.argsort(-costs, kind="stable"):
        while True:
            load, owned, dev = heapq.heappop(heap)
            if owned < cap:
                break
            parked.append((load, owned, dev))
            if not heap:
                heap, parked = parked, []
                heapq.heapify(heap)
        mapping[b] = dev
        heapq.heappush(heap, (load + costs[b], owned + 1, dev))
    if n_boxes == 0 or n == 1:
        return mapping
    for _ in range(sweeps):
        ld = loads(costs, mapping, n)
        src, dst = int(np.argmax(ld)), int(np.argmin(ld))
        src_boxes = np.where(mapping == src)[0]
        improved = False
        if dst != src and int(np.sum(mapping == dst)) < cap:
            for b in src_boxes[np.argsort(-costs[src_boxes])]:
                if max(ld[src] - costs[b], ld[dst] + costs[b]) < ld[src] - 1e-15:
                    mapping[b] = dst
                    improved = True
                    break
        if improved:
            continue
        done = False
        for b1 in src_boxes:
            for b2 in np.where(mapping == dst)[0]:
                if max(ld[src] + costs[b2] - costs[b1], ld[dst] + costs[b1] - costs[b2]) < ld[src] - 1e-15:
                    mapping[b1], mapping[b2] = dst, src
                    done = True
                    break
            if done:
                break
        if not done:
            break
    return mapping


def _spread(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                        (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                        (1, 0x5555555555555555)):
        v = (v | (v << np.uint64(shift))) & np.uint64(mask)
    return v


def morton_home(boxes_z: int, boxes_x: int, n: int) -> np.ndarray:
    """Home device of each box: its position on the Morton curve over
    (bz, bx), cut into ``n`` equal blocks."""
    bz, bx = np.divmod(np.arange(boxes_z * boxes_x), boxes_x)
    key = _spread(bz) | (_spread(bx) << np.uint64(1))
    pos = np.empty(len(key), np.int64)
    pos[np.argsort(key, kind="stable")] = np.arange(len(key))
    return pos // (len(key) // n)


def _ring(n: int, a, b):
    fwd = (np.asarray(b) - np.asarray(a)) % n
    return np.minimum(fwd, n - fwd)


def locality_repair(mapping, costs, home, n: int, max_shift: int = 1, sweeps: int = 4) -> np.ndarray:
    m = np.asarray(mapping, np.int64).copy()
    for _ in range(max(1, sweeps)):
        disp = _ring(n, home, m)
        violators = np.where(disp > max_shift)[0]
        if len(violators) == 0:
            break
        moved = False
        for b in violators[np.argsort(-disp[violators], kind="stable")]:
            if _ring(n, home[b], m[b]) <= max_shift:
                continue
            best = None
            for d in np.where(_ring(n, home[b], np.arange(n)) <= max_shift)[0]:
                partners = np.where(m == d)[0]
                for b2 in partners[_ring(n, home[partners], m[b]) <= max_shift]:
                    gap = abs(costs[b] - costs[b2])
                    if best is None or gap < best[0]:
                        best = (gap, b2)
            if best is not None:
                b2 = best[1]
                m[b], m[b2] = m[b2], m[b]
                moved = True
        if not moved:
            break
    return m


def replay(
    rounds: Sequence[np.ndarray],
    initial: np.ndarray,
    n: int,
    *,
    max_boxes: Optional[float],
    threshold: float,
    home: Optional[np.ndarray] = None,
) -> List[dict]:
    """Each round's decision from the costs it was offered: ``adopted`` and
    the ``mapping`` in force after it.  ``home`` turns on the sharded
    runtime's locality repair."""
    mapping = np.asarray(initial, np.int64).copy()
    out = []
    for costs in rounds:
        costs = np.asarray(costs, np.float64)
        proposed = knapsack(costs, n, max_boxes)
        adopt = efficiency(costs, proposed, n) > (1.0 + threshold) * efficiency(costs, mapping, n)
        if adopt:
            if home is not None:
                proposed = locality_repair(proposed, costs, home, n)
            mapping = proposed
        out.append({"adopted": bool(adopt), "mapping": mapping.copy()})
    return out
