"""The uniform plasma (arXiv 2104.11385 Fig. 7's strong-scaling baseline),
frozen.

A copy of what ``uniform_plasma_problem`` builds: ``ppc`` particles per
cell on average, placed uniformly over the whole domain, weight cell area /
ppc; electrons with Gaussian momenta of ``thermal_u`` in all three
components; ions of mass ``ion_mass`` at rest, at positions drawn afresh.
No laser.  The particles are drawn on the device.
"""
from __future__ import annotations

import torch

from . import PlainInputs, below, geometry

__all__ = ["draw"]


def draw(config: dict, gen: torch.Generator, device: torch.device) -> PlainInputs:
    g = geometry(config)
    n = g.nz * g.nx * int(config["ppc"])
    f32 = dict(dtype=torch.float32, device=device)
    w = torch.full((n,), g.dz * g.dx / int(config["ppc"]), **f32)
    thermal = float(config["thermal_u"])

    def positions():
        z = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * g.lz
        x = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * g.lx
        return below(z.to(torch.float32), g.lz), below(x.to(torch.float32), g.lx)

    ze, xe = positions()
    ue = [torch.randn(n, generator=gen, **f32) * thermal for _ in range(3)]
    electrons = dict(z=ze, x=xe, ux=ue[0], uy=ue[1], uz=ue[2], w=w, q=-1.0, m=1.0)
    zi, xi = positions()
    zero = torch.zeros(n, **f32)
    ions = dict(
        z=zi, x=xi, ux=zero, uy=zero.clone(), uz=zero.clone(), w=w.clone(),
        q=1.0, m=float(config["ion_mass"]),
    )
    return PlainInputs(
        geometry=g, species=(electrons, ions), laser=None, sponge_width=int(config["sponge_width"])
    )
