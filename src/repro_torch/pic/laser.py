"""Gaussian laser pulse injection by antenna (soft source).

Counterpart of ``repro.pic.laser`` (``inject`` only).  The paper's pulse:
a0 = 25, propagating along +z, polarized along x, injected from a plane at
fixed z; in normalized units ω0 = ω_pe/√5 and the peak field is a0·ω0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fields import Fields
from .grid import Grid2D

__all__ = ["LaserAntenna"]

#: default ω0 = 1/√5 with the square root taken in float32, as the
#: reference's default does
_OMEGA0_F32_SQRT = 1.0 / float(np.sqrt(np.float32(5.0)))


@dataclass(frozen=True)
class LaserAntenna:
    """Antenna source on the plane z = z_pos (nearest grid row)."""

    a0: float = 25.0
    omega0: float = _OMEGA0_F32_SQRT  # laser frequency / ω_pe
    waist: float = 8.0  # transverse 1/e field radius, c/ω_pe
    duration: float = 10.0  # 1/e field duration, 1/ω_pe
    t_peak: float = 30.0  # envelope peak time, 1/ω_pe
    z_pos: float = 2.0  # antenna plane, c/ω_pe
    x_center: float = 0.0  # transverse center, c/ω_pe

    def amplitude(self) -> float:
        """Peak normalized E field: a0 · ω0/ω_pe."""
        return self.a0 * self.omega0

    def inject(self, f: Fields, grid: Grid2D, t: torch.Tensor) -> Fields:
        """Add the soft source on Ex and By for one step.  ``t`` is a
        float32 tensor on the fields' device (no host transfer)."""
        row = int(round(self.z_pos / grid.dz))
        x = (torch.arange(grid.nx, device=f.ex.device) + 0.5) * grid.dx  # Ex at +1/2 in x
        transverse = torch.exp(-((x - self.x_center) ** 2) / self.waist**2)
        envelope = torch.exp(-(((t - self.t_peak) / self.duration) ** 2))
        carrier = torch.sin(self.omega0 * t)
        src = self.amplitude() * envelope * carrier * transverse * self.omega0 * grid.dt
        ex = f.ex.clone()
        ex[row] += src
        by = f.by.clone()
        by[row] += -src  # forward-propagating wave: By = -Ex
        return f._replace(ex=ex, by=by)
