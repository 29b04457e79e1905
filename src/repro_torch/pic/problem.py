"""Test problems + the named scenario registry.

Counterpart of ``repro.pic.problem``.  Every builder draws from
``np.random.default_rng(seed)`` in the same order as the reference, so the
initial species are bit-identical to the reference's; the arrays then land
on ``device`` (default ``"cuda"``).

The laser-ion problem is the paper's setup (§3.1), self-similarly scaled to
run on CPU: all dimensionless physics parameters match (n0 = 5 n_crit so
ω0 = ω_pe/√5, a0 = 25, exponential edge, electron thermal momentum 0.01 mc),
while the domain (in skin depths), particles per cell and ion mass ratio are
scaled down.  The paper's fiducial values are reachable by passing
scale=1.0, ppc=900, mass_ratio=1836.

Scenario registry
-----------------
A load balancer is only as proven as the imbalance characters it has been
run against — a drifting hotspot, a static gradient, and a uniform load
each favour a different strategy (cf. arXiv:1706.08362, arXiv:2003.10406).
Every problem builder registers under a name via :func:`register_scenario`
with that character as metadata; :func:`get_scenario` /
:func:`list_scenarios` are how the scenario-matrix benchmark
(``benchmarks/bench_scaling.py``) and ``tests/test_scenarios.py`` enumerate
them.  Builders share the ``(nz, nx, box_cells, ppc, seed, ...)`` keyword
signature so one set of fiducial kwargs scales every scenario.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .grid import Grid2D
from .laser import LaserAntenna
from .particles import Particles

__all__ = [
    "laser_ion_problem",
    "uniform_plasma_problem",
    "moving_laser_problem",
    "colliding_beams_problem",
    "density_ramp_problem",
    "uniform_null_problem",
    "ProblemSetup",
    "Scenario",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
]


@dataclass(frozen=True)
class ProblemSetup:
    grid: Grid2D
    species: Tuple[Particles, ...]
    laser: LaserAntenna | None
    name: str


@dataclass(frozen=True)
class Scenario:
    """A registered problem builder plus its load-imbalance character.

    ``imbalance`` names the character the balancer faces (``"drifting-
    hotspot"``, ``"merging-hotspots"``, ``"static-gradient"``,
    ``"uniform"``); ``expect_noop`` marks null cases where a correct
    balancer should do ~nothing (asserted by tests and the
    ``bench_scaling`` no-op gate)."""

    name: str
    build: Callable[..., ProblemSetup]
    imbalance: str
    expect_noop: bool = False
    description: str = ""


_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(
    name: str,
    build: Callable[..., ProblemSetup],
    *,
    imbalance: str,
    expect_noop: bool = False,
    description: str = "",
) -> Scenario:
    """Register ``build`` under ``name``; duplicate names are an error (a
    silently shadowed scenario would corrupt the benchmark trajectory)."""
    if name in _SCENARIOS:
        raise ValueError(f"scenario {name!r} is already registered")
    sc = Scenario(
        name=name,
        build=build,
        imbalance=imbalance,
        expect_noop=expect_noop,
        description=description or (build.__doc__ or "").strip().splitlines()[0],
    )
    _SCENARIOS[name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario; unknown names list what exists."""
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {list_scenarios()}"
        ) from None


def list_scenarios() -> List[str]:
    """Sorted names of every registered scenario."""
    return sorted(_SCENARIOS)


def _make_species(
    z: np.ndarray,
    x: np.ndarray,
    u: np.ndarray,
    w: np.ndarray,
    q: float,
    m: float,
    device: torch.device,
) -> Particles:
    n = len(z)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return Particles(
        z=f32(z),
        x=f32(x),
        ux=f32(u[:, 0]),
        uy=f32(u[:, 1]),
        uz=f32(u[:, 2]),
        w=f32(w),
        alive=torch.ones(n, dtype=torch.bool, device=device),
        q=f32(np.asarray(q)),
        m=f32(np.asarray(m)),
    )


def laser_ion_problem(
    nz: int = 192,
    nx: int = 192,
    box_cells: int = 32,
    ppc: int = 16,
    mass_ratio: float = 100.0,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Scaled laser-ion acceleration target (paper §3.1).

    Paper fiducial: 1920² cells of 0.274 c/ω_pe, 64² boxes, 900 ppc/species,
    target r_core=88 c/ω_pe (5 μm) + slope 35 (2 μm), edge scale L=0.88
    (50 nm), laser a0=25 from z=-9 μm focused at target center.  Here the
    domain is nz×nx cells at the same resolution; target and laser scale
    with the domain.
    """
    dz = dx = 0.274
    grid = Grid2D(nz=nz, nx=nx, dz=dz, dx=dx, box_nz=box_cells, box_nx=box_cells)
    rng = np.random.default_rng(seed)
    device = resolve_device(device)

    # target geometry (fractions of the paper's 526 c/ω_pe domain)
    lz, lx = grid.lz, grid.lx
    zc, xc = 0.55 * lz, 0.5 * lx  # target center (laser comes from low z)
    r_core = 0.17 * min(lz, lx)  # 5 μm / 30 μm ≈ 0.17
    r_slope = 0.4 * r_core  # 2 μm slope
    edge_scale = 0.01 * r_core + 0.05  # ~50 nm ≪ r_core; keep ≥ dz/5

    # per-cell density (n = 1 is the reference plasma density, 5 n_crit)
    zg = (np.arange(nz) + 0.5) * dz
    xg = (np.arange(nx) + 0.5) * dx
    rr = np.sqrt((zg[:, None] - zc) ** 2 + (xg[None, :] - xc) ** 2)
    density = np.where(
        rr <= r_core,
        1.0,
        np.where(rr <= r_core + r_slope, np.exp(-(rr - r_core) / edge_scale), 0.0),
    )
    # constant macroparticle count in the slope (paper: 'ring' of constant
    # markers for adequate absorption modeling) -> occupancy by density>eps
    occupied = np.argwhere(density > 1e-6)
    n_markers = len(occupied) * ppc

    cell_volume = dz * dx
    # particle positions: ppc random positions per occupied cell
    cz, cx = occupied[:, 0], occupied[:, 1]
    z = (np.repeat(cz, ppc) + rng.uniform(0, 1, n_markers)) * dz
    x = (np.repeat(cx, ppc) + rng.uniform(0, 1, n_markers)) * dx
    w = np.repeat(density[cz, cx], ppc) * cell_volume / ppc

    # electrons: Gaussian momenta along x and z, sigma = 0.01 mc
    ue = np.zeros((n_markers, 3))
    ue[:, 0] = rng.normal(0.0, 0.01, n_markers)  # ux
    ue[:, 2] = rng.normal(0.0, 0.01, n_markers)  # uz
    electrons = _make_species(z, x, ue, w, q=-1.0, m=1.0, device=device)

    # ions: at rest, same positions/weights (fresh sampling for positions)
    zi = (np.repeat(cz, ppc) + rng.uniform(0, 1, n_markers)) * dz
    xi = (np.repeat(cx, ppc) + rng.uniform(0, 1, n_markers)) * dx
    ions = _make_species(
        zi, xi, np.zeros((n_markers, 3)), w, q=+1.0, m=mass_ratio, device=device
    )

    laser = LaserAntenna(
        a0=25.0,
        omega0=1.0 / np.sqrt(5.0),
        waist=0.13 * lx,  # 4 μm / 30 μm
        duration=10.0 * 0.1 * (lz / 52.6),  # scale with domain; ~5 ω_pe⁻¹ small runs
        t_peak=0.25 * lz,  # reaches target as pulse develops
        z_pos=2.0 * dz * 4,
        x_center=xc,
    )
    return ProblemSetup(grid=grid, species=(electrons, ions), laser=laser, name="laser_ion")


def uniform_plasma_problem(
    nz: int = 128,
    nx: int = 128,
    box_cells: int = 32,
    ppc: int = 8,
    thermal_u: float = 0.01,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Domain filled uniformly with plasma (paper Fig. 7 baseline; 550 ppc
    there).  Perfectly balanced by construction — used for strong-scaling
    calibration and as the no-imbalance control."""
    dz = dx = 0.274
    grid = Grid2D(nz=nz, nx=nx, dz=dz, dx=dx, box_nz=box_cells, box_nx=box_cells)
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    n_markers = nz * nx * ppc
    z = rng.uniform(0, grid.lz, n_markers)
    x = rng.uniform(0, grid.lx, n_markers)
    w = np.full(n_markers, dz * dx / ppc)
    ue = rng.normal(0.0, thermal_u, (n_markers, 3))
    electrons = _make_species(z, x, ue, w, q=-1.0, m=1.0, device=device)
    ions = _make_species(
        rng.uniform(0, grid.lz, n_markers),
        rng.uniform(0, grid.lx, n_markers),
        np.zeros((n_markers, 3)),
        w,
        q=+1.0,
        m=100.0,
        device=device,
    )
    return ProblemSetup(grid=grid, species=(electrons, ions), laser=None, name="uniform_plasma")


def _drifting_pair(
    z: np.ndarray,
    x: np.ndarray,
    w: np.ndarray,
    drift: Tuple[float, float, float],
    rng: np.random.Generator,
    device: torch.device,
    thermal_u: float = 0.01,
    mass_ratio: float = 100.0,
) -> Tuple[Particles, Particles]:
    """Quasineutral electron/ion pair at the same positions with a common
    bulk momentum: equal charges moving together carry no net current, so a
    cold drifting structure is field-free until something perturbs it."""
    n = len(z)
    u = np.tile(np.asarray(drift, np.float64), (n, 1))
    ue = u + rng.normal(0.0, thermal_u, (n, 3))
    electrons = _make_species(z, x, ue, w, q=-1.0, m=1.0, device=device)
    ions = _make_species(z, x, u.copy(), w, q=+1.0, m=mass_ratio, device=device)
    return electrons, ions


def moving_laser_problem(
    nz: int = 128,
    nx: int = 128,
    box_cells: int = 32,
    ppc: int = 8,
    drift_u: float = 0.25,
    mass_ratio: float = 100.0,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Laser-swept target: the dense spot drifts transversely across box
    columns (a *drifting hotspot* — the imbalance character that defeats
    static balancing).

    The sweep is carried by the plasma: the laser-heated spot gets a bulk
    transverse momentum ``drift_u`` (both species together, so the drift is
    current-free) while the antenna plane itself stays fixed — the
    distributed runtimes inject through a precomputed static spatial
    profile (``LaserAntenna.profile``), and a time-dependent antenna would
    break that contract for every runtime at once.  The spot starts at
    0.3 lx and must stay inside the domain over the run: particles leaving
    the (non-periodic) domain are absorbed.
    """
    dz = dx = 0.274
    grid = Grid2D(nz=nz, nx=nx, dz=dz, dx=dx, box_nz=box_cells, box_nx=box_cells)
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    lz, lx = grid.lz, grid.lx
    zc, xc = 0.55 * lz, 0.3 * lx  # spot center; drifts toward +x
    r_spot = 0.15 * min(lz, lx)

    zg = (np.arange(nz) + 0.5) * dz
    xg = (np.arange(nx) + 0.5) * dx
    rr2 = (zg[:, None] - zc) ** 2 + (xg[None, :] - xc) ** 2
    density = np.exp(-rr2 / r_spot**2)
    occupied = np.argwhere(density > 1e-3)
    n_markers = len(occupied) * ppc
    cz, cx = occupied[:, 0], occupied[:, 1]
    z = (np.repeat(cz, ppc) + rng.uniform(0, 1, n_markers)) * dz
    x = (np.repeat(cx, ppc) + rng.uniform(0, 1, n_markers)) * dx
    w = np.repeat(density[cz, cx], ppc) * dz * dx / ppc
    electrons, ions = _drifting_pair(
        z, x, w, (drift_u, 0.0, 0.0), rng, device, mass_ratio=mass_ratio
    )

    laser = LaserAntenna(
        a0=25.0,
        omega0=1.0 / np.sqrt(5.0),
        waist=0.13 * lx,
        duration=10.0 * 0.1 * (lz / 52.6),
        t_peak=0.25 * lz,
        z_pos=2.0 * dz * 4,
        x_center=xc,
    )
    return ProblemSetup(
        grid=grid, species=(electrons, ions), laser=laser, name="moving_laser"
    )


def colliding_beams_problem(
    nz: int = 128,
    nx: int = 128,
    box_cells: int = 32,
    ppc: int = 8,
    beam_u: float = 0.3,
    mass_ratio: float = 100.0,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Two counter-streaming slabs collide at the domain center (*merging
    hotspots*): the load starts split across two box columns, converges,
    and doubles up mid-domain — any mapping computed from the initial
    state is wrong twice over.

    Slabs sit at 0.25 lx and 0.75 lx (width 0.2 lx, spanning all of z)
    with opposite transverse momenta ``±beam_u``; each slab is a
    quasineutral current-free electron/ion pair, so the streams
    free-stream toward each other rather than exploding electrostatically.
    The slabs are *transversely* stratified on purpose: the cost-oblivious
    initial round-robin mapping already spreads every box *row* across all
    devices, so a longitudinal structure would start perfectly balanced by
    accident and prove nothing — a transverse one lands whole slabs on few
    devices, which is the imbalance the balancer must fix.
    """
    dz = dx = 0.274
    grid = Grid2D(nz=nz, nx=nx, dz=dz, dx=dx, box_nz=box_cells, box_nx=box_cells)
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    lz, lx = grid.lz, grid.lx
    slab_w = 0.2 * lx
    n_slab = int(round(nz * nx * ppc * 0.2))  # same marker density as uniform ppc
    species: List[Particles] = []
    for xc, ux in ((0.25 * lx, +beam_u), (0.75 * lx, -beam_u)):
        z = rng.uniform(0, lz, n_slab)
        x = rng.uniform(xc - slab_w / 2, xc + slab_w / 2, n_slab)
        w = np.full(n_slab, (slab_w * lz) / n_slab)  # density 1 inside the slab
        e, i = _drifting_pair(z, x, w, (ux, 0.0, 0.0), rng, device, mass_ratio=mass_ratio)
        species.extend((e, i))
    return ProblemSetup(
        grid=grid, species=tuple(species), laser=None, name="colliding_beams"
    )


def density_ramp_problem(
    nz: int = 128,
    nx: int = 128,
    box_cells: int = 32,
    ppc: int = 8,
    ramp_scale: float = 0.3,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Exponential density ramp across box columns (a *static gradient*):
    the imbalance is strong but time-independent, so a single static
    rebalance captures almost all of the attainable speedup — the scenario
    separates "balances once, correctly" from "tracks a moving load".

    Density ∝ exp((x - lx) / (ramp_scale · lx)), carried by marker *count*
    (constant weights, positions drawn by inverse-CDF sampling) so per-box
    particle work follows the ramp exactly as cell density does.  The ramp
    runs *transversely* for the same reason the colliding beams do: the
    initial round-robin mapping balances longitudinal structure for free,
    and a gradient it cannot hide is what makes the static-LB comparison
    meaningful.
    """
    dz = dx = 0.274
    grid = Grid2D(nz=nz, nx=nx, dz=dz, dx=dx, box_nz=box_cells, box_nx=box_cells)
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    lz, lx = grid.lz, grid.lx
    L = ramp_scale * lx
    n_markers = nz * nx * ppc // 2  # mean density 1/2 of the uniform problem
    # inverse CDF of exp((x - lx)/L) on [0, lx]
    u = rng.uniform(0, 1, n_markers)
    span = 1.0 - np.exp(-lx / L)
    x = lx + L * np.log(1.0 - span * (1.0 - u))
    z = rng.uniform(0, lz, n_markers)
    # constant weight: total charge matches density exp((x-lx)/L) integrated
    w = np.full(n_markers, lz * L * span / n_markers)
    thermal = rng.normal(0.0, 0.01, (n_markers, 3))
    electrons = _make_species(z, x, thermal, w, q=-1.0, m=1.0, device=device)
    ions = _make_species(
        z, x, np.zeros((n_markers, 3)), w, q=+1.0, m=100.0, device=device
    )
    return ProblemSetup(
        grid=grid, species=(electrons, ions), laser=None, name="density_ramp"
    )


def uniform_null_problem(
    nz: int = 128,
    nx: int = 128,
    box_cells: int = 32,
    ppc: int = 8,
    seed: int = 0,
    device=None,
) -> ProblemSetup:
    """Uniform-load null case: every box costs the same, so a correct
    balancer should do ~nothing — rebalance count ≈ 0 and no slowdown vs
    ``lb_enabled=False`` (both asserted by ``tests/test_scenarios.py`` and
    the ``bench_scaling`` no-op gate).  Physically identical to
    ``uniform_plasma_problem``; registered separately so the no-op
    assertions track a stable name."""
    base = uniform_plasma_problem(
        nz=nz, nx=nx, box_cells=box_cells, ppc=ppc, seed=seed, device=device
    )
    return replace(base, name="uniform_null")


# -- the registry ----------------------------------------------------------
register_scenario(
    "laser_ion",
    laser_ion_problem,
    imbalance="drifting-hotspot",
    description="paper §3.1 laser-ion target: laser-driven hotspot on a dense disk",
)
register_scenario(
    "uniform_plasma",
    uniform_plasma_problem,
    imbalance="uniform",
    description="uniform plasma baseline (paper Fig. 7 strong-scaling calibration)",
)
register_scenario(
    "moving_laser",
    moving_laser_problem,
    imbalance="drifting-hotspot",
    description="laser-swept target: dense spot drifts across box columns",
)
register_scenario(
    "colliding_beams",
    colliding_beams_problem,
    imbalance="merging-hotspots",
    description="counter-streaming slabs converge and double up mid-domain",
)
register_scenario(
    "density_ramp",
    density_ramp_problem,
    imbalance="static-gradient",
    description="longitudinal exponential density ramp; static LB suffices",
)
register_scenario(
    "uniform_null",
    uniform_null_problem,
    imbalance="uniform",
    expect_noop=True,
    description="uniform-load null case: the balancer should do ~nothing",
)
