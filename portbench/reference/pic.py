"""A plain PyTorch PIC step: the yardstick the program's runs are held to.

Written from the physics, in the fewest plain tensor operations, and
independent of the program: it imports nothing of ``repro_torch`` or
``repro`` and reads only the benchmark's own :class:`PlainInputs`.  One
step, in the order the paper's loop runs it:

  1. gather E and B at every particle (order-3 B-splines on the Yee grid's
     staggered points, periodic);
  2. relativistic Boris push, then x += dt·u/γ; a particle that leaves the
     domain dies (dead particles keep their state from then on);
  3. direct order-3 deposition of J = q w u/γ / cell area at the new
     positions, periodic;
  4. Maxwell leapfrog (B half step, E full step with J, B half step), the
     laser antenna's soft source on its row, the multiplicative sponge.

``deposit_leavers`` says whether a particle that leaves the domain in a
step still deposits that step (``Simulation`` over the binned kernels
does, at its periodic image; ``ShardedRuntime`` does not).

``dtype`` is the precision of the fields, currents, momenta and weights;
positions stay float32.  The benchmark runs it in float32, the precision
the configurations state; the control runs it in bfloat16 (positions of a
526 c/ω_pe domain in bfloat16 would be off by several cells, which no
program would do).  Particles go through in blocks so that the full-size
problems fit beside nothing else.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["run", "box_ids", "SPONGE_STRENGTH"]

#: the absorbing layer's damping at the domain edge (1 - 0.2 (1 - d/width)^2)
SPONGE_STRENGTH = 0.2
#: particles per block
BLOCK = 1 << 22


def _spline_weights(pos: torch.Tensor, spacing: float, offset: float, dtype):
    """Base index floor(s) - 1 and the four cubic B-spline weights of
    positions ``pos`` for a quantity staggered by ``offset`` cells."""
    s = pos / spacing - offset
    fl = torch.floor(s)
    frac = s - fl
    d = torch.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], dim=-1).abs()
    inner = 2.0 / 3.0 - d**2 + 0.5 * d**3
    outer = (2.0 - d) ** 3 / 6.0
    w = torch.where(d <= 1.0, inner, torch.where(d <= 2.0, outer, torch.zeros_like(d)))
    return fl.long() - 1, w.to(dtype)


def _stencil(iz, ix, nz: int, nx: int) -> torch.Tensor:
    """Flat periodic cell index of each particle's 4x4 stencil: (B, 4, 4)."""
    offs = torch.arange(4, device=iz.device)
    rows = torch.remainder(iz[:, None] + offs, nz)
    cols = torch.remainder(ix[:, None] + offs, nx)
    return rows[:, :, None] * nx + cols[:, None, :]


def _weights_by_stagger(z, x, g, dtype):
    """Stencil indices and weights for the four (z, x) staggerings the
    components use: (0, 1/2), (0, 0), (1/2, 0), (1/2, 1/2)."""
    iz0, wz0 = _spline_weights(z, g.dz, 0.0, dtype)
    izh, wzh = _spline_weights(z, g.dz, 0.5, dtype)
    ix0, wx0 = _spline_weights(x, g.dx, 0.0, dtype)
    ixh, wxh = _spline_weights(x, g.dx, 0.5, dtype)
    return {
        (0, 1): (_stencil(iz0, ixh, g.nz, g.nx), wz0, wxh),
        (0, 0): (_stencil(iz0, ix0, g.nz, g.nx), wz0, wx0),
        (1, 0): (_stencil(izh, ix0, g.nz, g.nx), wzh, wx0),
        (1, 1): (_stencil(izh, ixh, g.nz, g.nx), wzh, wxh),
    }


#: Yee staggering (z, x) in half cells of ex, ey, ez, bx, by, bz and of jx, jy, jz
_FIELD_STAGGER = ((0, 1), (0, 0), (1, 0), (1, 0), (1, 1), (0, 1))
_CURRENT_STAGGER = ((0, 1), (0, 0), (1, 0))


def box_ids(z: torch.Tensor, x: torch.Tensor, g) -> torch.Tensor:
    """Box of each position: the cell index truncated toward zero, clipped
    into the boundary boxes."""
    bz = torch.clamp((z / (g.dz * g.box_nz)).to(torch.int32), 0, g.boxes_z - 1)
    bx = torch.clamp((x / (g.dx * g.box_nx)).to(torch.int32), 0, g.boxes_x - 1)
    return bz.long() * g.boxes_x + bx.long()


def _push_block(sp, sl, flat_fields, g, dt, dtype, deposit_leavers, j_flat):
    """Steps 1-3 for the particles ``sl`` of one species, in place."""
    z, x = sp["z"][sl], sp["x"][sl]
    alive = sp["alive"][sl]
    st = _weights_by_stagger(z, x, g, dtype)
    e_b = []
    for c, key in enumerate(_FIELD_STAGGER):
        idx, wz, wx = st[key]
        vals = flat_fields[c][idx]
        e_b.append(((vals * wz[:, :, None]).sum(1) * wx).sum(1))
    ex, ey, ez, bx, by, bz = e_b
    del st
    qmdt2 = (sp["q"] / sp["m"]) * 0.5 * dt
    ux, uy, uz = sp["ux"][sl], sp["uy"][sl], sp["uz"][sl]
    umx, umy, umz = ux + qmdt2 * ex, uy + qmdt2 * ey, uz + qmdt2 * ez
    gamma_m = torch.sqrt(1.0 + umx**2 + umy**2 + umz**2)
    tx, ty, tz = (qmdt2 / gamma_m * b for b in (bx, by, bz))
    t2 = tx**2 + ty**2 + tz**2
    upx = umx + (umy * tz - umz * ty)
    upy = umy + (umz * tx - umx * tz)
    upz = umz + (umx * ty - umy * tx)
    s = 2.0 / (1.0 + t2)
    nux = umx + s * (upy * tz - upz * ty) + qmdt2 * ex
    nuy = umy + s * (upz * tx - upx * tz) + qmdt2 * ey
    nuz = umz + s * (upx * ty - upy * tx) + qmdt2 * ez
    gamma = torch.sqrt(1.0 + nux**2 + nuy**2 + nuz**2)
    nz_ = z + dt * (nuz / gamma).to(torch.float32)
    nx_ = x + dt * (nux / gamma).to(torch.float32)
    inside = (nz_ >= 0.0) & (nz_ < g.lz) & (nx_ >= 0.0) & (nx_ < g.lx)
    alive_new = alive & inside
    deposits = alive if deposit_leavers else alive_new
    coef = torch.where(deposits, sp["q"] * sp["w"][sl], torch.zeros_like(sp["w"][sl]))
    coef = coef / (gamma * (g.dz * g.dx))
    st = _weights_by_stagger(nz_, nx_, g, dtype)
    cells = g.nz * g.nx
    for c, (key, u) in enumerate(zip(_CURRENT_STAGGER, (nux, nuy, nuz))):
        idx, wz, wx = st[key]
        patch = (coef * u)[:, None, None] * wz[:, :, None] * wx[:, None, :]
        j_flat.index_add_(0, (idx + c * cells).reshape(-1), patch.reshape(-1))
    for k, new in (("z", nz_), ("x", nx_), ("ux", nux), ("uy", nuy), ("uz", nuz)):
        sp[k][sl] = torch.where(alive, new, sp[k][sl])
    sp["alive"][sl] = alive_new


def _roll(f, shift, dim):
    return torch.roll(f, shift, dims=dim)


def _field_phase(F, J, g, dt, laser, sponge, t):
    """Step 4 on the (6, nz, nx) fields with the (3, nz, nx) current."""
    ex, ey, ez, bx, by, bz = F
    jx, jy, jz = J

    def b_half(ex, ey, ez, bx, by, bz):
        h = 0.5 * dt
        bx = bx + h * ((_roll(ey, -1, 0) - ey) / g.dz)
        by = by - h * ((_roll(ex, -1, 0) - ex) / g.dz - (_roll(ez, -1, 1) - ez) / g.dx)
        bz = bz - h * ((_roll(ey, -1, 1) - ey) / g.dx)
        return bx, by, bz

    bx, by, bz = b_half(ex, ey, ez, bx, by, bz)
    ex = ex + dt * (-((by - _roll(by, 1, 0)) / g.dz) - jx)
    ey = ey + dt * ((bx - _roll(bx, 1, 0)) / g.dz - (bz - _roll(bz, 1, 1)) / g.dx - jy)
    ez = ez + dt * ((by - _roll(by, 1, 1)) / g.dx - jz)
    bx, by, bz = b_half(ex, ey, ez, bx, by, bz)
    if laser is not None:
        row = int(round(laser["z_pos"] / g.dz))
        xs = (torch.arange(g.nx, device=F.device) + 0.5) * g.dx
        transverse = torch.exp(-((xs - laser["x_center"]) ** 2) / laser["waist"] ** 2)
        envelope = torch.exp(-(((t - laser["t_peak"]) / laser["duration"]) ** 2))
        carrier = torch.sin(laser["omega0"] * t)
        amp = laser["a0"] * laser["omega0"]
        src = (amp * envelope * carrier * transverse * laser["omega0"] * dt).to(F.dtype)
        ex = ex.clone()
        by = by.clone()
        ex[row] += src
        by[row] -= src
    return torch.stack([ex, ey, ez, bx, by, bz]) * sponge


def _sponge(g, width: int, device, dtype) -> torch.Tensor:
    iz = torch.arange(g.nz, device=device)
    ix = torch.arange(g.nx, device=device)
    edge_z = torch.minimum(iz, g.nz - 1 - iz)
    edge_x = torch.minimum(ix, g.nx - 1 - ix)
    dist = torch.minimum(edge_z[:, None], edge_x[None, :]).to(torch.float32)
    ramp = torch.clamp(dist / width, 0.0, 1.0) if width > 0 else torch.ones_like(dist)
    return (1.0 - SPONGE_STRENGTH * (1.0 - ramp) ** 2).to(dtype)


def run(
    inputs,
    n_steps: int,
    *,
    deposit_leavers: bool,
    dtype=torch.float32,
    device=None,
    block: int = BLOCK,
) -> Dict[str, object]:
    """Advance ``inputs`` ``n_steps`` steps from rest fields at t = 0.

    Returns ``fields`` (6, nz, nx) float32, ``species`` (one dict per
    species: ``z, x, ux, uy, uz`` float32 and ``alive``, in input order),
    and ``counts`` (n_steps, n_species, n_boxes) int64, each box's alive
    particles at the start of each step."""
    g = inputs.geometry
    device = torch.device(device) if device is not None else inputs.species[0]["z"].device
    dt = g.dt
    species: List[Dict[str, object]] = []
    for sp in inputs.species:
        species.append(
            dict(
                z=sp["z"].to(device, torch.float32, copy=True),
                x=sp["x"].to(device, torch.float32, copy=True),
                ux=sp["ux"].to(device, dtype, copy=True),
                uy=sp["uy"].to(device, dtype, copy=True),
                uz=sp["uz"].to(device, dtype, copy=True),
                w=sp["w"].to(device, dtype, copy=True),
                alive=torch.ones(sp["z"].shape, dtype=torch.bool, device=device),
                q=float(sp["q"]),
                m=float(sp["m"]),
            )
        )
    F = torch.zeros((6, g.nz, g.nx), dtype=dtype, device=device)
    sponge = _sponge(g, inputs.sponge_width, device, dtype)
    counts = torch.zeros((n_steps, len(species), g.n_boxes), dtype=torch.int64, device=device)
    for step in range(n_steps):
        t = torch.tensor(step * dt, dtype=torch.float32, device=device)
        flat_fields = F.reshape(6, -1)
        J = torch.zeros(3 * g.nz * g.nx, dtype=dtype, device=device)
        for s, sp in enumerate(species):
            ids = box_ids(sp["z"], sp["x"], g)
            counts[step, s] = torch.bincount(ids[sp["alive"]], minlength=g.n_boxes)
            n = sp["z"].numel()
            for b0 in range(0, n, block):
                _push_block(sp, slice(b0, min(n, b0 + block)), flat_fields, g, dt, dtype,
                            deposit_leavers, J)
        F = _field_phase(F, J.view(3, g.nz, g.nx), g, dt, inputs.laser, sponge, t)
    out_species = [
        {k: (sp[k].to(torch.float32) if k != "alive" else sp[k]) for k in ("z", "x", "ux", "uy", "uz", "alive")}
        for sp in species
    ]
    return {"fields": F.to(torch.float32), "species": out_species, "counts": counts}
