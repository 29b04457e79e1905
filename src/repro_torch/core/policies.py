"""Distribution-mapping policies: knapsack and Morton-SFC (paper §2.2).

A *distribution mapping* is an ``np.ndarray`` of shape ``(n_boxes,)`` whose
entry ``b`` is the device (MPI rank / GPU / TPU chip) owning box ``b``.

Two policies from the paper:

  * ``knapsack_partition`` — spread costs as evenly as possible with no
    spatial constraint (AMReX-style greedy LPT + pairwise swap refinement,
    with an optional cap on boxes-per-device, default 1.5x the average, as in
    AMReX).  Extended beyond the paper with *capacity awareness* for
    heterogeneous / straggling devices.
  * ``sfc_partition`` — enumerate boxes along a Morton Z-order space-filling
    curve and split the curve into contiguous segments; the split is solved
    *optimally* (min-max segment cost) by binary search + greedy feasibility,
    which is at least as good as AMReX's volume-based split.
"""
from __future__ import annotations

import heapq
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "knapsack_partition",
    "sfc_partition",
    "morton_index",
    "device_loads",
    "round_robin_mapping",
    "locality_repair",
    "hop_radius",
]


def _as_costs(costs) -> np.ndarray:
    costs = np.asarray(costs, dtype=np.float64)
    if costs.ndim != 1:
        raise ValueError("costs must be 1-D (one entry per box)")
    if np.any(costs < 0) or not np.all(np.isfinite(costs)):
        raise ValueError("costs must be finite and non-negative")
    return costs


def device_loads(
    costs: np.ndarray, mapping: np.ndarray, n_devices: int, capacities: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-device load: sum of owned box costs, divided by device capacity."""
    costs = _as_costs(costs)
    mapping = np.asarray(mapping)
    loads = np.zeros(n_devices, dtype=np.float64)
    np.add.at(loads, mapping, costs)
    if capacities is not None:
        capacities = np.asarray(capacities, dtype=np.float64)
        if capacities.shape != (n_devices,) or np.any(capacities <= 0):
            raise ValueError("capacities must be positive with shape (n_devices,)")
        loads = loads / capacities
    return loads


def round_robin_mapping(n_boxes: int, n_devices: int) -> np.ndarray:
    """The cost-oblivious default mapping (what 'no load balancing' uses)."""
    return np.arange(n_boxes, dtype=np.int64) % n_devices


# ---------------------------------------------------------------------------
# Knapsack
# ---------------------------------------------------------------------------


def knapsack_partition(
    costs,
    n_devices: int,
    *,
    capacities: Optional[Sequence[float]] = None,
    max_boxes_per_device: Optional[float] = 1.5,
    refine_sweeps: int = 4,
) -> np.ndarray:
    """Greedy LPT knapsack with pairwise-swap refinement.

    Parameters
    ----------
    costs:
        per-box costs.
    n_devices:
        number of devices to distribute over.
    capacities:
        optional per-device relative speeds (1.0 = nominal).  A straggler
        detected by in-situ measurement gets capacity < 1 and receives
        proportionally less work (beyond-paper extension; see
        ``repro.dist.straggler``).
    max_boxes_per_device:
        cap on boxes per device expressed as a multiple of the average
        (AMReX default 1.5).  ``None`` disables the cap.
    refine_sweeps:
        number of swap-refinement sweeps after the greedy pass.
    """
    costs = _as_costs(costs)
    n_boxes = costs.shape[0]
    if n_devices <= 0:
        raise ValueError("n_devices must be positive")
    if capacities is None:
        caps = np.ones(n_devices, dtype=np.float64)
    else:
        caps = np.asarray(capacities, dtype=np.float64)
        if caps.shape != (n_devices,) or np.any(caps <= 0):
            raise ValueError("capacities must be positive with shape (n_devices,)")

    if max_boxes_per_device is None:
        cap_boxes = n_boxes  # effectively uncapped
    else:
        cap_boxes = max(1, int(np.ceil(max_boxes_per_device * n_boxes / n_devices)))

    mapping = np.empty(n_boxes, dtype=np.int64)
    # Greedy LPT: heaviest box first onto the effectively-lightest device.
    order = np.argsort(-costs, kind="stable")
    # heap of (effective_load, n_boxes_owned, device)
    heap = [(0.0, 0, d) for d in range(n_devices)]
    heapq.heapify(heap)
    parked = []  # devices that hit the box cap
    for b in order:
        while True:
            load, owned, dev = heapq.heappop(heap)
            if owned < cap_boxes:
                break
            parked.append((load, owned, dev))
            if not heap:  # all devices at cap (cap_boxes*n_devices >= n_boxes ensures rare)
                heap, parked = parked, []
                heapq.heapify(heap)
        mapping[b] = dev
        heapq.heappush(heap, (load + costs[b] / caps[dev], owned + 1, dev))

    _refine_swaps(costs, mapping, n_devices, caps, refine_sweeps, cap_boxes)
    return mapping


def _refine_swaps(
    costs: np.ndarray,
    mapping: np.ndarray,
    n_devices: int,
    caps: np.ndarray,
    sweeps: int,
    cap_boxes: Optional[int] = None,
) -> None:
    """AMReX-style efficiency refinement: move/swap boxes off the max-loaded
    device whenever doing so lowers the maximum effective load. In-place.

    Honours ``cap_boxes``: a single-box move is skipped when it would push
    the destination past the boxes-per-device cap (swaps preserve counts,
    so they are always legal).  With ``max_boxes_per_device=1.0`` this
    makes the whole knapsack pipeline count-preserving — the invariant the
    sharded runtime's equal-slot layout relies on.
    """
    if len(costs) == 0 or n_devices == 1:
        return
    for _ in range(max(0, sweeps)):
        loads = device_loads(costs, mapping, n_devices, caps)
        src = int(np.argmax(loads))
        improved = False
        src_boxes = np.where(mapping == src)[0]
        # try single-box moves to the lightest device (cap permitting)
        dst = int(np.argmin(loads))
        if dst != src and (
            cap_boxes is None or int(np.sum(mapping == dst)) < cap_boxes
        ):
            for b in src_boxes[np.argsort(-costs[src_boxes])]:
                new_src = loads[src] - costs[b] / caps[src]
                new_dst = loads[dst] + costs[b] / caps[dst]
                if max(new_src, new_dst) < loads[src] - 1e-15:
                    mapping[b] = dst
                    improved = True
                    break
        if not improved:
            # try pairwise swaps src<->dst
            dst_boxes = np.where(mapping == dst)[0]
            done = False
            for b1 in src_boxes:
                for b2 in dst_boxes:
                    new_src = loads[src] + (costs[b2] - costs[b1]) / caps[src]
                    new_dst = loads[dst] + (costs[b1] - costs[b2]) / caps[dst]
                    if max(new_src, new_dst) < loads[src] - 1e-15:
                        mapping[b1], mapping[b2] = dst, src
                        done = True
                        break
                if done:
                    break
            if not done:
                return  # no improving move: fixed point


# ---------------------------------------------------------------------------
# Locality-aware refinement (neighbour-collective mappings)
#
# The sharded runtime's ``comm="neighbor"`` path exchanges guard strips via
# per-offset ``ppermute`` hops, so its traffic is bounded by the *ring
# distance* between a box's owner and the owners of its 8 grid neighbours.
# The cost-only knapsack is free to scatter boxes anywhere; these helpers
# pull a proposed mapping back toward the locality-preserving slot curve
# (``repro.pic.boxes.box_slot_layout``) without disturbing the balance the
# knapsack found: pure pairwise swaps, preferring partners of similar cost.
# ---------------------------------------------------------------------------


def _ring_dist(n: int, a, b) -> np.ndarray:
    fwd = (np.asarray(b) - np.asarray(a)) % n
    return np.minimum(fwd, n - fwd)


def hop_radius(mapping, home_devices, n_devices: int) -> int:
    """Largest ring distance between any box's device and its curve-home
    device — the displacement metric :func:`locality_repair` bounds (the
    neighbour exchange's offset set grows with it)."""
    mapping = np.asarray(mapping)
    home = np.asarray(home_devices)
    if len(mapping) == 0:
        return 0
    return int(_ring_dist(n_devices, home, mapping).max())


def locality_repair(
    mapping,
    costs,
    home_devices,
    n_devices: int,
    *,
    max_shift: int = 1,
    sweeps: int = 4,
) -> np.ndarray:
    """Swap boxes until every box sits within ``max_shift`` ring hops of
    its curve-home device.  Count-preserving (pure swaps) and best-effort
    load-preserving: each displaced box trades places with the
    closest-cost box currently occupying one of its allowed devices whose
    own home constraint tolerates the box's device.  Boxes that cannot be
    repaired without breaking a partner's constraint are left in place
    (the neighbour exchange stays *correct* at any displacement — only its
    hop set grows), so the result is a repair, not a guarantee.
    """
    costs = _as_costs(costs)
    m = np.asarray(mapping, dtype=np.int64).copy()
    home = np.asarray(home_devices, dtype=np.int64)
    if m.shape != home.shape or m.shape != costs.shape:
        raise ValueError("mapping, costs and home_devices must agree on n_boxes")
    for _ in range(max(1, sweeps)):
        disp = _ring_dist(n_devices, home, m)
        violators = np.where(disp > max_shift)[0]
        if len(violators) == 0:
            break
        moved = False
        # worst displacement first: those have the fewest options left
        for b in violators[np.argsort(-disp[violators], kind="stable")]:
            if _ring_dist(n_devices, home[b], m[b]) <= max_shift:
                continue  # fixed by an earlier swap this sweep
            allowed = np.where(_ring_dist(n_devices, home[b], np.arange(n_devices)) <= max_shift)[0]
            best = None  # (cost gap, partner box)
            for d in allowed:
                partners = np.where(m == d)[0]
                # the partner inherits b's device: its own home must tolerate it
                ok = partners[_ring_dist(n_devices, home[partners], m[b]) <= max_shift]
                for b2 in ok:
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


# ---------------------------------------------------------------------------
# Morton space-filling curve
# ---------------------------------------------------------------------------


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of x so there is a 0 bit between each (2-D)."""
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two 0 bits between each (3-D)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_index(coords: np.ndarray) -> np.ndarray:
    """Morton (Z-order) index for integer box coordinates.

    ``coords``: int array of shape (n_boxes, ndim) with ndim in {1, 2, 3}.
    """
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] not in (1, 2, 3):
        raise ValueError("coords must have shape (n_boxes, ndim) with ndim in {1,2,3}")
    if np.any(coords < 0):
        raise ValueError("box coordinates must be non-negative")
    ndim = coords.shape[1]
    if ndim == 1:
        return coords[:, 0].astype(np.uint64)
    if ndim == 2:
        return _part1by1(coords[:, 0]) | (_part1by1(coords[:, 1]) << np.uint64(1))
    return (
        _part1by2(coords[:, 0])
        | (_part1by2(coords[:, 1]) << np.uint64(1))
        | (_part1by2(coords[:, 2]) << np.uint64(2))
    )


def _min_max_contiguous_split(costs: np.ndarray, n_segments: int) -> np.ndarray:
    """Optimal split of a cost sequence into <= n_segments contiguous segments
    minimizing the maximum segment sum.  Returns segment id per position.

    Binary search on the bottleneck T + greedy feasibility. O(n log(sum/eps)).
    """
    n = len(costs)
    seg_of = np.zeros(n, dtype=np.int64)
    if n == 0:
        return seg_of

    def n_segments_needed(T: float) -> int:
        segs, acc = 1, 0.0
        for c in costs:
            if acc + c > T:
                segs += 1
                acc = c
            else:
                acc += c
        return segs

    lo, hi = float(np.max(costs)), float(np.sum(costs))
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if n_segments_needed(mid) <= n_segments:
            hi = mid
        else:
            lo = mid
    T = hi
    seg, acc = 0, 0.0
    for i, c in enumerate(costs):
        if acc + c > T and seg + 1 < n_segments:
            seg += 1
            acc = c
        else:
            acc += c
        seg_of[i] = seg
    return seg_of


def sfc_partition(
    costs,
    n_devices: int,
    *,
    box_coords: np.ndarray,
) -> np.ndarray:
    """Morton Z-order SFC partition (paper §2.2).

    Boxes are ordered along the Z-curve through their integer coordinates and
    the curve is cut into ``n_devices`` contiguous segments with (optimally)
    balanced cost.  GPU ownership is contiguous along the curve, giving the
    spatial-locality property discussed in the paper (large unicolored patches
    in low-cost regions, small patches in high-cost regions — Fig. 4b).
    """
    costs = _as_costs(costs)
    box_coords = np.asarray(box_coords)
    if box_coords.shape[0] != costs.shape[0]:
        raise ValueError("box_coords and costs must agree on n_boxes")
    z = morton_index(box_coords)
    order = np.argsort(z, kind="stable")
    seg_of_sorted = _min_max_contiguous_split(costs[order], n_devices)
    mapping = np.empty(len(costs), dtype=np.int64)
    mapping[order] = seg_of_sorted
    return mapping
