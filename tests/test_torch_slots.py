"""The port's slot-batched phases against the JAX package's, on the same
slot stacks (numpy-seeded, converted to both).

``particle_phase_stacked`` / ``field_phase_stacked`` are held to the
reference's vmapped forms: fields and deposits within 2e-5·max|ref|,
particle state rtol 2e-5, counts exact.  ``particle_phase_slots`` (the
kernels' plain versions on CPU tensors) is held to the reference's with
the Pallas kernels in interpret mode on the five adversarial slot
geometries of ``tests/test_kernel_backends.py``: work counters bitwise,
and current conservation as the reference checks it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import particle_phase_slots as j_slots
from repro.pic import engine as jengine
from repro.pic.deposition import box_work_counters as j_work
from repro.pic.grid import Grid2D as JGrid
from repro.pic.laser import LaserAntenna as JLaser
from repro.pic.particles import Particles as JParticles

from repro_torch import convert
from repro_torch.kernels.ops import particle_phase_slots as t_slots
from repro_torch.pic import engine as tengine
from repro_torch.pic.deposition import box_work_counters as t_work
from repro_torch.pic.grid import Grid2D as TGrid

GRID = dict(nz=16, nx=16, dz=0.5, dx=0.5, box_nz=8, box_nx=8)
LEAVES = ("z", "x", "ux", "uy", "uz", "w")


def _local(kw, halo):
    pnz, pnx = kw["box_nz"] + 2 * halo, kw["box_nx"] + 2 * halo
    return dict(nz=pnz, nx=pnx, dz=kw["dz"], dx=kw["dx"], box_nz=pnz, box_nx=pnx)


def _slot_stack(counts, cap, halo, spread="interior", seed=0, q=-1.0, m=1.0):
    """Numpy slot stacks: ``counts[s]`` live particles in slot ``s`` (box
    ``s``), placed inside the box or within one cell of its edges."""
    grid = JGrid(**GRID)
    S = grid.n_boxes
    counts = np.asarray(counts, np.int64)
    rng = np.random.default_rng(seed)
    z = np.empty((S, cap), np.float32)
    x = np.empty((S, cap), np.float32)
    lz_b, lx_b = grid.box_nz * grid.dz, grid.box_nx * grid.dx
    for s, (bz, bx) in enumerate(np.asarray(grid.box_coords)):
        z0, x0 = bz * lz_b, bx * lx_b
        if spread == "edges":
            edge = rng.uniform(0.0, grid.dz, cap).astype(np.float32)
            side = rng.integers(0, 4, cap)
            z[s] = np.where(side == 0, z0 + edge, np.where(side == 1, z0 + lz_b - edge, z0 + rng.uniform(0, lz_b, cap)))
            x[s] = np.where(side == 2, x0 + edge, np.where(side == 3, x0 + lx_b - edge, x0 + rng.uniform(0, lx_b, cap)))
        else:
            z[s] = z0 + rng.uniform(0.05, 0.95, cap) * lz_b
            x[s] = x0 + rng.uniform(0.05, 0.95, cap) * lx_b
        np.clip(z[s], z0, np.nextafter(np.float32(z0 + lz_b), 0), out=z[s])
        np.clip(x[s], x0, np.nextafter(np.float32(x0 + lx_b), 0), out=x[s])
    u = (rng.standard_normal((3, S, cap)) * 0.1).astype(np.float32)
    leaves = dict(
        z=z, x=x, ux=u[0], uy=u[1], uz=u[2],
        w=rng.uniform(0.5, 1.5, (S, cap)).astype(np.float32),
        alive=np.arange(cap)[None, :] < counts[:, None],
        q=np.float32(q), m=np.float32(m),
    )
    origins = np.stack(
        [[(bz * grid.box_nz - halo) * grid.dz, (bx * grid.box_nx - halo) * grid.dx]
         for bz, bx in np.asarray(grid.box_coords)]
    ).astype(np.float32)
    pn = _local(GRID, halo)
    tiles6 = (rng.standard_normal((S, 6, pn["nz"], pn["nx"])) * 0.01).astype(np.float32)
    return leaves, origins, tiles6


def _jparticles(leaves):
    return JParticles(**{k: jnp.asarray(v) for k, v in leaves.items()})


def _tparticles(leaves):
    return convert.particles_from(type("P", (), leaves), "cpu")


def _assert_close(a, b, name, rtol=2e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("halo", [4, 5])
def test_particle_phase_stacked_matches_reference(order, halo):
    two = [_slot_stack([40, 7, 0, 64], 64, halo, seed=1),
           _slot_stack([5, 64, 33, 12], 64, halo, spread="edges", seed=2, q=1.0, m=100.0)]
    tiles6 = two[0][2]
    origins = two[0][1]
    jl, tl = JGrid(**_local(GRID, halo)), TGrid(**_local(GRID, halo))
    jg, tg = JGrid(**GRID), TGrid(**GRID)
    j_sp, j_j3, j_counts = jengine.particle_phase_stacked(
        jnp.asarray(tiles6), tuple(_jparticles(l) for l, _, _ in two), jnp.asarray(origins), jl,
        domain_grid=jg, shape_order=order,
    )
    t_sp, t_j3, t_counts = tengine.particle_phase_stacked(
        torch.from_numpy(tiles6), tuple(_tparticles(l) for l, _, _ in two), torch.from_numpy(origins), tl,
        domain_grid=tg, shape_order=order,
    )
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    ref = np.asarray(j_j3)
    assert t_j3.shape == ref.shape
    assert np.abs(t_j3.numpy() - ref).max() <= 2e-5 * max(np.abs(ref).max(), 1e-30)
    for a, b in zip(t_sp, j_sp):
        np.testing.assert_array_equal(a.alive.numpy(), np.asarray(b.alive))
        for k in LEAVES:
            _assert_close(getattr(a, k).numpy(), getattr(b, k), k)


@pytest.mark.parametrize("with_laser", [True, False])
@pytest.mark.parametrize("halo", [4, 5])
def test_field_phase_stacked_matches_reference(halo, with_laser):
    rng = np.random.default_rng(halo)
    pn = _local(GRID, halo)
    S = JGrid(**GRID).n_boxes
    tiles6 = rng.standard_normal((S, 6, pn["nz"], pn["nx"])).astype(np.float32)
    j3 = (rng.standard_normal((S, 3, pn["nz"], pn["nx"])) * 0.1).astype(np.float32)
    static2 = np.stack(
        [rng.uniform(0.8, 1.0, (S, pn["nz"], pn["nx"])), rng.uniform(0.0, 1.0, (S, pn["nz"], pn["nx"]))], 1
    ).astype(np.float32)
    jlaser = JLaser() if with_laser else None
    tlaser = convert.laser_from(jlaser)
    t = 29.5
    ref = np.asarray(
        jengine.field_phase_stacked(
            jnp.asarray(tiles6), jnp.asarray(j3), jnp.asarray(static2), jnp.float32(t),
            JGrid(**pn), halo, laser=jlaser,
        )
    )
    got = tengine.field_phase_stacked(
        torch.from_numpy(tiles6), torch.from_numpy(j3), torch.from_numpy(static2),
        torch.full((), t), TGrid(**pn), halo, laser=tlaser,
    ).numpy()
    assert got.shape == ref.shape == (S, 6, GRID["box_nz"], GRID["box_nx"])
    for c in range(6):
        assert np.abs(got[:, c] - ref[:, c]).max() <= 2e-5 * max(np.abs(ref[:, c]).max(), 1e-30), c


ADVERSARIAL = [
    pytest.param([0, 0, 0, 0], "interior", id="all-empty"),
    pytest.param([512, 0, 0, 0], "interior", id="all-in-one-box"),
    pytest.param([512, 512, 512, 512], "interior", id="at-capacity"),
    pytest.param([1, 255, 256, 257], "interior", id="tile-boundaries"),
    pytest.param([137, 256, 0, 490], "edges", id="box-edge-seam"),
]


def _run_slots(counts, spread, halo=3):
    leaves, origins, tiles6 = _slot_stack(counts, 512, halo, spread=spread)
    jl, tl = JGrid(**_local(GRID, halo)), TGrid(**_local(GRID, halo))
    ref = j_slots(
        jnp.asarray(tiles6), (_jparticles(leaves),), jnp.asarray(origins), jl,
        domain_grid=JGrid(**GRID), interpret=True,
    )
    got = t_slots(
        torch.from_numpy(tiles6), (_tparticles(leaves),), torch.from_numpy(origins), tl,
        domain_grid=TGrid(**GRID),
    )
    return ref, got


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_slot_counters_bitwise(counts, spread):
    """The port's counters equal the reference kernels' and the
    ``box_work_counters`` formula bitwise; the rest of the phase agrees."""
    (j_sp, j_j3, j_counts, j_w), (t_sp, t_j3, t_counts, t_w) = _run_slots(counts, spread)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(
        t_work(torch.tensor(counts), TGrid(**GRID)).numpy(), np.asarray(j_work(jnp.asarray(counts), JGrid(**GRID)))
    )
    np.testing.assert_array_equal(t_w.numpy(), t_work(torch.tensor(counts), TGrid(**GRID)).numpy())
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    ref = np.asarray(j_j3)
    assert np.abs(t_j3.numpy() - ref).max() <= 2e-5 * max(np.abs(ref).max(), 1e-30)
    (a,), (b,) = t_sp, j_sp
    np.testing.assert_array_equal(a.alive.numpy(), np.asarray(b.alive))
    for k in LEAVES:
        _assert_close(getattr(a, k).numpy(), getattr(b, k), k)


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_slot_deposition_conserves_current(counts, spread):
    """Order-3 weights sum to 1, so each slot tile's summed deposit equals
    the analytic sum over its surviving particles."""
    _, (t_sp, t_j3, _, _) = _run_slots(counts, spread)
    (q,) = t_sp
    grid = TGrid(**GRID)
    inv_vol = 1.0 / (grid.dz * grid.dx)
    ux, uy, uz, w = (getattr(q, k).numpy().astype(np.float64) for k in ("ux", "uy", "uz", "w"))
    gamma = np.sqrt(1.0 + ux**2 + uy**2 + uz**2)
    coef = np.where(q.alive.numpy(), -1.0 * w * inv_vol, 0.0) / gamma
    expect = np.stack([(coef * u).sum(axis=1) for u in (ux, uy, uz)], axis=1)
    got = t_j3.numpy().sum(axis=(2, 3))
    scale = max(np.abs(expect).max(), 1e-6)
    np.testing.assert_allclose(got, expect, atol=2e-4 * scale)


def test_slot_dead_lanes_keep_their_state():
    """The kernels push the dead lanes of executed chunks; the phase must
    hand those lanes back unchanged, as the reference does."""
    leaves, origins, tiles6 = _slot_stack([100, 3, 0, 300], 512, 4, seed=5)
    p = _tparticles(leaves)
    (out,), _, _, _ = t_slots(
        torch.from_numpy(tiles6), (p,), torch.from_numpy(origins), TGrid(**_local(GRID, 4)),
        domain_grid=TGrid(**GRID),
    )
    dead = ~p.alive
    for k in ("z", "x", "ux", "uy", "uz"):
        assert torch.equal(getattr(out, k)[dead], getattr(p, k)[dead]), k


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_slot_phases_split_over_logical_devices(n_dev, backend):
    """A slot stack split over logical devices (``convert.slots_from``)
    advances slot for slot as the whole stack does, bitwise: the phases
    never mix slots."""
    leaves, origins, tiles6 = _slot_stack([40, 7, 0, 256], 256, 4, seed=9)
    local, grid = TGrid(**_local(GRID, 4)), TGrid(**GRID)
    stack = {k: leaves[k] for k in LEAVES + ("alive",)}

    def phase(sp, o, t6):
        p = convert.particles_from(type("P", (), dict(sp, q=-1.0, m=1.0)), "cpu")
        if backend == "torch":
            out, j3, counts = tengine.particle_phase_stacked(t6, (p,), o, local, domain_grid=grid)
        else:
            out, j3, counts, _ = t_slots(t6, (p,), o, local, domain_grid=grid)
        return {k: getattr(out[0], k) for k in LEAVES + ("alive",)}, j3, counts

    whole = phase({k: torch.from_numpy(v) for k, v in stack.items()},
                  torch.from_numpy(origins), torch.from_numpy(tiles6))
    blocks = convert.slots_from(dict(stack, origins=origins, tiles6=tiles6), ["cpu"] * n_dev)
    parts = [phase({k: b[k] for k in stack}, b["origins"], b["tiles6"]) for b in blocks]
    merged = convert.slots_to_numpy([p[0] for p in parts])
    for k in LEAVES + ("alive",):
        np.testing.assert_array_equal(merged[k], whole[0][k].numpy(), err_msg=k)
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(), whole[1].numpy())
    np.testing.assert_array_equal(torch.cat([p[2] for p in parts]).numpy(), whole[2].numpy())


@pytest.mark.parametrize("order", [1, 3])
def test_particle_phase_on_a_padded_tile_matches_reference(order):
    """``particle_phase`` with ``origin``/``domain_grid``: one box's padded
    tile, particles in domain coordinates, the kill at the domain edge."""
    from repro.pic.fields import Fields as JFields

    from repro_torch.pic.fields import Fields as TFields

    halo, slot = 4, 3
    leaves, origins, tiles6 = _slot_stack([5, 64, 33, 64], 64, halo, spread="edges", seed=4)
    one = {k: (v[slot] if np.ndim(v) else v) for k, v in leaves.items()}
    oz, ox = (float(v) for v in origins[slot])
    jl, tl = JGrid(**_local(GRID, halo)), TGrid(**_local(GRID, halo))
    (j_p,), j_j, j_counts = jengine.particle_phase(
        JFields(*jnp.asarray(tiles6[slot])), (_jparticles(one),), jl, order,
        domain_grid=JGrid(**GRID), origin=(jnp.float32(oz), jnp.float32(ox)),
    )
    (t_p,), t_j, t_counts = tengine.particle_phase(
        TFields(*torch.from_numpy(tiles6[slot])), (_tparticles(one),), tl, order,
        domain_grid=TGrid(**GRID), origin=(torch.tensor(oz), torch.tensor(ox)),
    )
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    for a, b in zip(t_j, j_j):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-30)
    np.testing.assert_array_equal(t_p.alive.numpy(), np.asarray(j_p.alive))
    for k in LEAVES:
        _assert_close(getattr(t_p, k).numpy(), getattr(j_p, k), k)
