"""Box decomposition bookkeeping (counterpart of ``repro.pic.boxes``'s
``BoxDecomposition``).

The single-device simulation keeps global field/particle tensors; boxes
exist as an accounting structure: cost measurement, distribution mapping,
data volumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .grid import Grid2D

__all__ = ["BoxDecomposition"]


@dataclass
class BoxDecomposition:
    """Box geometry + data-volume model for a grid."""

    grid: Grid2D
    bytes_per_cell: float = 9 * 4  # 6 field + 3 current components, f32
    bytes_per_particle: float = 7 * 4  # z,x,ux,uy,uz,w,alive

    @property
    def n_boxes(self) -> int:
        return self.grid.n_boxes

    @property
    def coords(self) -> np.ndarray:
        return self.grid.box_coords

    @property
    def neighbors(self) -> List[List[int]]:
        return self.grid.box_neighbors

    def box_slices(self, box_id: int) -> Tuple[slice, slice]:
        """(z, x) slices of ``box_id``'s interior in the global grid."""
        bz, bx = self.coords[box_id]
        g = self.grid
        return (
            slice(bz * g.box_nz, (bz + 1) * g.box_nz),
            slice(bx * g.box_nx, (bx + 1) * g.box_nx),
        )

    def box_bytes(self, n_particles_per_box: np.ndarray) -> np.ndarray:
        """Redistribution payload per box: its cells + its particles."""
        cells = self.grid.cells_per_box * self.bytes_per_cell
        return cells + np.asarray(n_particles_per_box) * self.bytes_per_particle

    def surface_bytes(self) -> np.ndarray:
        """Halo payload per box per step (guard-cell exchange)."""
        return np.full(
            self.n_boxes, self.grid.box_surface_cells * self.bytes_per_cell, dtype=np.float64
        )
