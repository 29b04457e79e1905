"""The benchmark's inputs: one plain description of a PIC problem, drawn on
the device from the run's seed.

A configuration file names its ``scenario``; the module
``portbench/inputs/<scenario>.py`` holds a frozen copy of that scenario's
geometry and distributions and draws the particles with a
``torch.Generator`` on the device.  What comes back is plain tensors and
numbers (:class:`PlainInputs`): the reference reads them as they are, and
``portbench.entries`` hands the same tensors to the program.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = ["PlainInputs", "Geometry", "draw", "generator"]


@dataclass(frozen=True)
class Geometry:
    nz: int
    nx: int
    dz: float
    dx: float
    box_nz: int
    box_nx: int
    cfl: float

    @property
    def lz(self) -> float:
        return self.nz * self.dz

    @property
    def lx(self) -> float:
        return self.nx * self.dx

    @property
    def dt(self) -> float:
        return self.cfl / (1.0 / self.dz**2 + 1.0 / self.dx**2) ** 0.5

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


@dataclass(frozen=True)
class PlainInputs:
    """A seeded PIC problem as plain data.

    ``species`` holds one dict per species with float32 tensors ``z, x, ux,
    uy, uz, w`` (one entry per particle, all alive) and the floats ``q`` and
    ``m``; ``laser`` is ``None`` or a dict of the antenna's numbers;
    ``sponge_width`` the damping layer's depth in cells."""

    geometry: Geometry
    species: Tuple[Dict[str, object], ...]
    laser: Optional[Dict[str, float]]
    sponge_width: int

    @property
    def n_particles(self) -> int:
        return sum(int(sp["z"].numel()) for sp in self.species)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed (any
    non-negative whole number; folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def geometry(config: dict) -> Geometry:
    return Geometry(
        nz=int(config["nz"]),
        nx=int(config["nx"]),
        dz=float(config["dz"]),
        dx=float(config["dx"]),
        box_nz=int(config["box_cells"]),
        box_nx=int(config["box_cells"]),
        cfl=float(config["cfl"]),
    )


def below(v: torch.Tensor, limit: float) -> torch.Tensor:
    """``v`` (float32) clamped strictly below the float32 value of
    ``limit``, so no particle starts on the domain's far edge."""
    top = torch.nextafter(
        torch.tensor(limit, dtype=torch.float32), torch.tensor(0.0, dtype=torch.float32)
    )
    return torch.minimum(v, top.to(v.device))


def draw(config: dict, seed: int, device) -> PlainInputs:
    """Draw the problem ``config`` describes with ``seed`` on ``device``."""
    module = importlib.import_module(f"portbench.inputs.{config['scenario']}")
    return module.draw(config, generator(seed, device), torch.device(device))
