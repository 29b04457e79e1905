"""Yee grid geometry and field-component staggering (2D, z-x plane).

Counterpart of ``repro.pic.grid``.  Axis 0 = z, axis 1 = x; y is out of
plane.  Yee staggering offsets (in cells) per component:

    Ex (0, 1/2)   Ey (0, 0)     Ez (1/2, 0)
    Bx (1/2, 0)   By (1/2, 1/2) Bz (0, 1/2)
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["Grid2D", "STAGGER"]

#: (off_z, off_x) staggering per field/current component
STAGGER: Dict[str, Tuple[float, float]] = {
    "ex": (0.0, 0.5),
    "ey": (0.0, 0.0),
    "ez": (0.5, 0.0),
    "bx": (0.5, 0.0),
    "by": (0.5, 0.5),
    "bz": (0.0, 0.5),
    "jx": (0.0, 0.5),
    "jy": (0.0, 0.0),
    "jz": (0.5, 0.0),
}


@dataclass(frozen=True)
class Grid2D:
    """Rectilinear 2D grid with box decomposition metadata.

    nz, nx:    number of cells along z, x.
    dz, dx:    cell size (units of c/ω_pe).
    box_nz, box_nx:
               box size in cells; must tile the grid exactly (the paper's
               fiducial box is 64x64).
    cfl:       fraction of the CFL-stable timestep (paper: 0.999).
    """

    nz: int
    nx: int
    dz: float
    dx: float
    box_nz: int = 64
    box_nx: int = 64
    cfl: float = 0.999

    def __post_init__(self):
        if self.nz % self.box_nz or self.nx % self.box_nx:
            raise ValueError(
                f"boxes ({self.box_nz}x{self.box_nx}) must tile the grid ({self.nz}x{self.nx})"
            )

    @property
    def lz(self) -> float:
        return self.nz * self.dz

    @property
    def lx(self) -> float:
        return self.nx * self.dx

    @property
    def dt(self) -> float:
        """CFL-limited FDTD timestep (c = 1)."""
        return self.cfl / np.sqrt(1.0 / self.dz**2 + 1.0 / self.dx**2)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nz, self.nx)

    @property
    def n_cells(self) -> int:
        return self.nz * self.nx

    @property
    def boxes_z(self) -> int:
        return self.nz // self.box_nz

    @property
    def boxes_x(self) -> int:
        return self.nx // self.box_nx

    @property
    def n_boxes(self) -> int:
        return self.boxes_z * self.boxes_x

    @property
    def cells_per_box(self) -> int:
        return self.box_nz * self.box_nx

    @cached_property
    def box_coords(self) -> np.ndarray:
        """Integer (bz, bx) coordinates per box id, shape (n_boxes, 2);
        box id = bz * boxes_x + bx."""
        bz, bx = np.divmod(np.arange(self.n_boxes), self.boxes_x)
        return np.stack([bz, bx], axis=1)

    @cached_property
    def box_neighbors(self) -> list:
        """4-neighbourhood (non-periodic) adjacency per box, for the
        halo-exchange communication model."""
        out = []
        for bz, bx in self.box_coords:
            nbrs = []
            for dz_, dx_ in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                z, x = bz + dz_, bx + dx_
                if 0 <= z < self.boxes_z and 0 <= x < self.boxes_x:
                    nbrs.append(int(z * self.boxes_x + x))
            out.append(nbrs)
        return out

    @property
    def box_surface_cells(self) -> int:
        """Guard-cell count proxy for one box's halo (perimeter cells)."""
        return 2 * (self.box_nz + self.box_nx)

    def box_of_position(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Box id (int64) for physical positions.  The cell index truncates
        toward zero, then positions outside the domain clip into the
        boundary boxes."""
        bz = torch.clamp((z / (self.dz * self.box_nz)).to(torch.int32), 0, self.boxes_z - 1)
        bx = torch.clamp((x / (self.dx * self.box_nx)).to(torch.int32), 0, self.boxes_x - 1)
        return bz.long() * self.boxes_x + bx.long()
