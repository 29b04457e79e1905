"""Block-sharded FDTD field solve over a grid of logical devices
(counterpart of ``repro.pic.sharded``; the bulk-synchronous path).

The grid is split into ``(pz, px)`` blocks, z over the mesh's rows and x
over its columns, each block a set of tensors on its own logical device (a
``torch.device``; any number may be the same card).  Each block updates its
part of the field after pulling one-cell edge rows or columns from its ring
neighbours with ``Tensor.to`` (the reference's ``ppermute``).  The rings
wrap around, so the blocks reproduce the global solver's periodic
differences: the numerics are the global solver's (``step_b_half``,
``step_e``) up to f32 rounding.

:func:`field_shardings` splits a global field or current into blocks and
joins blocks back (the reference's ``NamedSharding``);
:func:`make_sharded_fdtd_step` returns one full leapfrog step (B half, E
full, B half) on blocks.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import torch

from .fields import Fields
from .grid import Grid2D

__all__ = ["make_sharded_fdtd_step", "field_shardings", "FieldShardings"]

#: blocks[iz][ix]: one tensor per logical device of the (pz, px) mesh
Blocks = List[List[torch.Tensor]]
Mesh = Sequence[Sequence[Union[str, torch.device]]]


class FieldShardings(NamedTuple):
    """``split(tensor) -> Blocks`` puts the ``(nz, nx)`` tensor's blocks on
    the mesh's devices; ``join(blocks) -> tensor`` assembles them on
    ``device`` (default: the first block's)."""

    split: Callable[[torch.Tensor], Blocks]
    join: Callable[..., torch.Tensor]


def _mesh_devices(mesh: Mesh) -> List[List[torch.device]]:
    devs = [[torch.device(d) for d in row] for row in mesh]
    if not devs or not devs[0] or any(len(row) != len(devs[0]) for row in devs):
        raise ValueError("mesh must be a non-empty (pz, px) grid of devices")
    return devs


def field_shardings(grid: Grid2D, mesh: Mesh) -> FieldShardings:
    """Block split and join of ``grid``-shaped tensors over ``mesh``."""
    devs = _mesh_devices(mesh)
    pz, px = len(devs), len(devs[0])
    if grid.nz % pz or grid.nx % px:
        raise ValueError(f"a {grid.nz}x{grid.nx} grid does not split into {pz}x{px} blocks")
    bz, bx = grid.nz // pz, grid.nx // px

    def split(t: torch.Tensor) -> Blocks:
        return [
            [t[iz * bz:(iz + 1) * bz, ix * bx:(ix + 1) * bx].to(devs[iz][ix]).contiguous()
             for ix in range(px)]
            for iz in range(pz)
        ]

    def join(blocks: Blocks, device=None) -> torch.Tensor:
        dev = blocks[0][0].device if device is None else torch.device(device)
        return torch.cat(
            [torch.cat([b.to(dev) for b in row], dim=1) for row in blocks], dim=0
        )

    return FieldShardings(split, join)


def _neighbor_row(blocks: Blocks, iz: int, ix: int, axis: int, direction: int) -> torch.Tensor:
    """The edge a block needs from its ring neighbour along ``axis`` (0: z
    over the mesh rows, 1: x over its columns), on the block's device:
    ``direction=+1`` the next block's first row/column, ``-1`` the previous
    block's last one."""
    pz, px = len(blocks), len(blocks[0])
    if axis == 0:
        src = blocks[(iz + direction) % pz][ix]
        edge = src[:1] if direction > 0 else src[-1:]
    else:
        src = blocks[iz][(ix + direction) % px]
        edge = src[:, :1] if direction > 0 else src[:, -1:]
    return edge.to(blocks[iz][ix].device, non_blocking=True)


def _ddz_fwd(blocks: Blocks, iz: int, ix: int, dz: float) -> torch.Tensor:
    f = blocks[iz][ix]
    shifted = torch.cat([f[1:], _neighbor_row(blocks, iz, ix, 0, +1)], dim=0)
    return (shifted - f) / dz


def _ddz_bwd(blocks: Blocks, iz: int, ix: int, dz: float) -> torch.Tensor:
    f = blocks[iz][ix]
    shifted = torch.cat([_neighbor_row(blocks, iz, ix, 0, -1), f[:-1]], dim=0)
    return (f - shifted) / dz


def _ddx_fwd(blocks: Blocks, iz: int, ix: int, dx: float) -> torch.Tensor:
    f = blocks[iz][ix]
    shifted = torch.cat([f[:, 1:], _neighbor_row(blocks, iz, ix, 1, +1)], dim=1)
    return (shifted - f) / dx


def _ddx_bwd(blocks: Blocks, iz: int, ix: int, dx: float) -> torch.Tensor:
    f = blocks[iz][ix]
    shifted = torch.cat([_neighbor_row(blocks, iz, ix, 1, -1), f[:, :-1]], dim=1)
    return (f - shifted) / dx


def make_sharded_fdtd_step(
    grid: Grid2D, mesh: Mesh
) -> Tuple[Callable[[Fields, Tuple[Blocks, Blocks, Blocks]], Fields], FieldShardings]:
    """``(step, shardings)``: ``step(fields, j) -> fields`` is one full
    leapfrog step (B half, E full, B half) where every component of
    ``fields`` and ``j`` is ``Blocks`` over ``mesh`` (made with
    ``shardings.split``).  Each sub-update reads the previous sub-update's
    blocks of every device, as the reference's collectives do."""
    shardings = field_shardings(grid, mesh)
    dz, dx, dt = grid.dz, grid.dx, grid.dt
    hdt = 0.5 * dt
    pz, px = len(mesh), len(mesh[0])
    cells = [(iz, ix) for iz in range(pz) for ix in range(px)]

    def per_block(fn) -> Blocks:
        out = [[None] * px for _ in range(pz)]
        for iz, ix in cells:
            out[iz][ix] = fn(iz, ix)
        return out

    def b_half(f: Fields) -> Fields:
        bx = per_block(lambda iz, ix: f.bx[iz][ix] + hdt * _ddz_fwd(f.ey, iz, ix, dz))
        by = per_block(lambda iz, ix: f.by[iz][ix] - hdt * (
            _ddz_fwd(f.ex, iz, ix, dz) - _ddx_fwd(f.ez, iz, ix, dx)))
        bz = per_block(lambda iz, ix: f.bz[iz][ix] - hdt * _ddx_fwd(f.ey, iz, ix, dx))
        return f._replace(bx=bx, by=by, bz=bz)

    def step(fields: Fields, j: Tuple[Blocks, Blocks, Blocks]) -> Fields:
        jx, jy, jz = j
        f = b_half(fields)
        ex = per_block(lambda iz, ix: f.ex[iz][ix] + dt * (-_ddz_bwd(f.by, iz, ix, dz) - jx[iz][ix]))
        ey = per_block(lambda iz, ix: f.ey[iz][ix] + dt * (
            _ddz_bwd(f.bx, iz, ix, dz) - _ddx_bwd(f.bz, iz, ix, dx) - jy[iz][ix]))
        ez = per_block(lambda iz, ix: f.ez[iz][ix] + dt * (_ddx_bwd(f.by, iz, ix, dx) - jz[iz][ix]))
        return b_half(f._replace(ex=ex, ey=ey, ez=ez))

    return step, shardings
