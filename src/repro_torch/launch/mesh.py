"""The 1-D ring of logical devices the sharded PIC runtime spreads box slots
over (counterpart of ``repro.launch.mesh``'s ring helpers).

The reference builds a ``jax.sharding.Mesh`` and runs one ``shard_map``
program over it.  The port keeps that single-controller design without a
mesh object: a "mesh" is the tuple of ``torch.device`` s of its logical
devices, one per ring position, and any number of them may name the same
card.  ``ring_offset``, ``ring_distance`` and ``slot_home_devices`` are the
reference's numpy helpers, copied.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["make_box_mesh", "ring_offset", "ring_distance", "slot_home_devices"]


def ring_offset(n: int, src, dst):
    """Forward ring offset ``(dst - src) mod n`` on an ``n``-device ring:
    the key the neighbour collectives bucket payloads by (arrays
    broadcast)."""
    return (np.asarray(dst) - np.asarray(src)) % n


def ring_distance(n: int, a, b):
    """Undirected hop distance between devices ``a`` and ``b`` on the ring
    (the locality metric ``core.policies.locality_repair`` bounds)."""
    fwd = ring_offset(n, a, b)
    return np.minimum(fwd, n - fwd)


def slot_home_devices(curve_pos: np.ndarray, n_devices: int) -> np.ndarray:
    """Home device per box under a locality-preserving slot curve:
    ``curve_pos`` is ``pic.boxes.box_slot_layout``'s slot per box, and with
    equal-count slot blocks box ``b``'s home owns curve slot
    ``curve_pos[b]``."""
    curve_pos = np.asarray(curve_pos)
    if len(curve_pos) % n_devices:
        raise ValueError(
            f"{len(curve_pos)} slots do not split evenly over {n_devices} devices"
        )
    return curve_pos // (len(curve_pos) // n_devices)


def make_box_mesh(
    n_devices: int,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.device, ...]:
    """The ``torch.device`` of each of ``n_devices`` logical devices.

    ``devices`` names them (the first ``n_devices`` are used); without it
    every logical device is ``resolve_device(device)``, so the default is
    ``n_devices`` copies of ``"cuda"``, which raises without a GPU.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if devices is None:
        return (resolve_device(device),) * n_devices
    avail = [resolve_device(d) for d in devices]
    if len(avail) < n_devices:
        raise RuntimeError(f"mesh needs {n_devices} devices but {len(avail)} were given")
    return tuple(avail[:n_devices])
