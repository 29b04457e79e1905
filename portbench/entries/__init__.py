"""The program's entry points as the benchmark drives them.

A traffic file names its ``entry``; ``portbench/entries/<entry>.py`` holds a
class ``Entry`` built from the domain's plain inputs, the configuration and
the traffic mix, with what the harness calls:

  * ``remake()``: build the program's runtime from the inputs kept on the
    device (the start of every stretch);
  * ``run_interval()``: advance ``interval`` steps through the program's
    own call, ending in its fetch; ``stretch_done`` says when the stretch
    of ``stretch_intervals`` intervals is complete;
  * ``rows()``: what the program fetched for each interval of the stretch,
    each row with ``dropped`` (work the program dropped) and ``finite``;
  * ``host_stats()``: the program's own host clocks, where it keeps them;
  * ``outcome()``: the state the stretch produced, in the plain form the
    domain's ``numbers`` judges;
  * ``release()``: drop the runtime.

Whatever else an entry offers is for its domain's ``context`` and
reference: the PIC entries add ``tile_cells()``, ``kernel_launches(rows)``
and ``alive_per_step(rows)``, and the path's semantics ``DEPOSIT_LEAVERS``
and ``ORDER_KEPT``; ``kernel_cap`` and ``to_problem`` below serve them.

This is the only place the benchmark imports the program.
"""
from __future__ import annotations

import importlib

__all__ = ["module", "to_problem", "kernel_cap"]


def module(name: str):
    """``portbench/entries/<name>.py``: its ``Entry``, and for a PIC entry
    the path's semantics the reference follows: ``DEPOSIT_LEAVERS`` (a
    particle leaving the domain deposits in that step) and ``ORDER_KEPT``
    (particles keep their input order, so they are compared one by one)."""
    return importlib.import_module(f"portbench.entries.{name}")


def kernel_cap(inputs, factor: int, tile: int = 256) -> int:
    """Bin capacity: ``factor`` × the worst initial box's particles (all
    species), rounded up to whole chunks of ``tile`` lanes."""
    import torch

    from portbench.reference.pic import box_ids

    g = inputs.geometry
    total = None
    for sp in inputs.species:
        c = torch.bincount(box_ids(sp["z"], sp["x"], g), minlength=g.n_boxes)
        total = c if total is None else total + c
    worst = int(total.max())
    return max(1, -(-worst * factor // tile)) * tile


def to_problem(inputs):
    """The program's ``ProblemSetup`` over the benchmark's own tensors."""
    import torch

    from repro_torch.pic import Grid2D, LaserAntenna, Particles, ProblemSetup

    g = inputs.geometry
    grid = Grid2D(nz=g.nz, nx=g.nx, dz=g.dz, dx=g.dx, box_nz=g.box_nz, box_nx=g.box_nx, cfl=g.cfl)
    species = []
    for sp in inputs.species:
        dev = sp["z"].device
        species.append(
            Particles(
                z=sp["z"], x=sp["x"], ux=sp["ux"], uy=sp["uy"], uz=sp["uz"], w=sp["w"],
                alive=torch.ones(sp["z"].shape, dtype=torch.bool, device=dev),
                q=torch.tensor(float(sp["q"]), dtype=torch.float32, device=dev),
                m=torch.tensor(float(sp["m"]), dtype=torch.float32, device=dev),
            )
        )
    laser = None if inputs.laser is None else LaserAntenna(**inputs.laser)
    return ProblemSetup(grid=grid, species=tuple(species), laser=laser, name="portbench")
