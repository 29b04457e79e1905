"""Carry state from the reference package into the port's objects.

The functions take numpy arrays and plain Python values (anything with the
reference's attribute names; ``np.asarray`` is applied to every leaf), so
this module imports nothing of the reference.  The tests use it to hand a
reference ``ProblemSetup`` or field state to the port, and
:func:`particles_to_numpy` / :func:`fields_to_numpy` take the port's
tensors back to numpy for comparison.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .pic.fields import Fields
from .pic.grid import Grid2D
from .pic.laser import LaserAntenna
from .pic.particles import Particles
from .pic.problem import ProblemSetup

__all__ = [
    "grid_from",
    "laser_from",
    "particles_from",
    "fields_from",
    "problem_from",
    "particles_to_numpy",
    "fields_to_numpy",
]

_PARTICLE_LEAVES = ("z", "x", "ux", "uy", "uz", "w", "alive", "q", "m")
_FIELD_LEAVES = ("ex", "ey", "ez", "bx", "by", "bz")
_LASER_FIELDS = ("a0", "omega0", "waist", "duration", "t_peak", "z_pos", "x_center")


def grid_from(g) -> Grid2D:
    """A port ``Grid2D`` with the same geometry as ``g``."""
    return Grid2D(
        nz=int(g.nz), nx=int(g.nx), dz=float(g.dz), dx=float(g.dx),
        box_nz=int(g.box_nz), box_nx=int(g.box_nx), cfl=float(g.cfl),
    )


def laser_from(laser) -> LaserAntenna | None:
    if laser is None:
        return None
    return LaserAntenna(**{k: float(getattr(laser, k)) for k in _LASER_FIELDS})


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def particles_from(p, device) -> Particles:
    """Port ``Particles`` from an object with the reference's leaves."""
    return Particles(*(_tensor(getattr(p, k), device) for k in _PARTICLE_LEAVES))


def fields_from(f, device) -> Fields:
    """Port ``Fields`` from six components (an object with ex..bz, or a sequence)."""
    comps: Sequence = (
        [getattr(f, k) for k in _FIELD_LEAVES] if hasattr(f, "ex") else list(f)
    )
    return Fields(*(_tensor(c, device) for c in comps))


def problem_from(setup, device) -> ProblemSetup:
    """Port ``ProblemSetup`` from the reference's (grid, species, laser, name)."""
    return ProblemSetup(
        grid=grid_from(setup.grid),
        species=tuple(particles_from(p, device) for p in setup.species),
        laser=laser_from(setup.laser),
        name=str(setup.name),
    )


def particles_to_numpy(p: Particles) -> Dict[str, np.ndarray]:
    return {k: getattr(p, k).detach().cpu().numpy() for k in _PARTICLE_LEAVES}


def fields_to_numpy(f: Fields) -> Dict[str, np.ndarray]:
    return {k: getattr(f, k).detach().cpu().numpy() for k in _FIELD_LEAVES}
