"""Meshes of logical devices (counterpart of ``repro.launch.mesh``).

The 1-D ring the sharded PIC runtime spreads box slots over: the reference
builds a ``jax.sharding.Mesh`` and runs one ``shard_map`` program over it.
The port keeps that single-controller design without a mesh object there:
``make_box_mesh`` returns the tuple of ``torch.device`` s of its logical
devices, one per ring position, and any number of them may name the same
card.  ``ring_offset``, ``ring_distance`` and ``slot_home_devices`` are the
reference's numpy helpers, copied.

The named meshes the sharding rules (``repro_torch.dist.sharding``) place
over: :class:`Mesh` holds axis names and a numpy object array of
``torch.device`` s.  ``make_production_mesh`` builds the reference's
production layouts, 16x16 ``("data", "model")`` or 2x16x16 ``("pod",
"data", "model")``.  Its logical devices are an argument: by default all of
them name the one card, and ``device="meta"`` gives the dry run's 256 or
512 devices that hold shapes only (the reference fakes 512 host devices
through ``XLA_FLAGS`` for the same purpose, which needs no counterpart
here).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "make_production_mesh",
    "make_box_mesh",
    "as_mesh",
    "require_devices",
    "ring_offset",
    "ring_distance",
    "slot_home_devices",
]

#: mesh axis name the PIC runtimes shard box slots over
BOX_AXIS = "boxes"


class Mesh:
    """Named axes over an array of logical devices: ``axis_names``, the
    ordered ``shape`` (axis name -> extent) and ``devices``, a numpy object
    array of ``torch.device`` s with one dim per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.vectorize(torch.device, otypes=[object])(np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """A ``shape`` mesh whose every logical device is
    ``resolve_device(device)`` (default ``"cuda"``, which raises without a
    GPU)."""
    dev = resolve_device(device)
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [dev] * devices.size
    return Mesh(devices.reshape(tuple(shape)), axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 ``("data", "model")`` logical devices, or 2x16x16 ``("pod",
    "data", "model")`` with ``multi_pod`` (data-parallel across pods; the
    slow-link axis)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def as_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`; a tuple of devices (what
    :func:`make_box_mesh` returns) as the 1-D ``("boxes",)`` mesh."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(list(mesh), (BOX_AXIS,))


def require_devices(n: int, devices: Optional[Iterable] = None) -> None:
    """Raise unless at least ``n`` devices are given (default: the CUDA
    devices visible)."""
    have = torch.cuda.device_count() if devices is None else len(list(devices))
    if have < n:
        raise RuntimeError(
            f"mesh needs {n} devices but only {have} are given; the production meshes "
            "take their logical devices as an argument (make_production_mesh(device=...), "
            "device='meta' for the dry run)"
        )


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
