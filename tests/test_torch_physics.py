"""The port's physics modules against ``repro.pic`` on the same inputs.

Inputs come from numpy seeds and go through both packages.  Tolerances:
positions/indices and counts exact; shape weights, field updates and the
laser source to a few float32 ulps (rtol 1e-6); gathered fields and pushed
momenta rtol 2e-5 / atol 1e-6 and J atol 3e-4 (``tests/test_kernels.py``:
the reference and the port sum in different orders); ``box_work_counters``
bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import random_particles
from repro.pic import deposition as jdep
from repro.pic import fields as jfields
from repro.pic import particles as jpart
from repro.pic import shapes as jshapes
from repro.pic.grid import Grid2D as JGrid
from repro.pic.laser import LaserAntenna as JLaser

from repro_torch import convert
from repro_torch.pic import deposition as tdep
from repro_torch.pic import fields as tfields
from repro_torch.pic import particles as tpart
from repro_torch.pic import shapes as tshapes
from repro_torch.pic.laser import LaserAntenna as TLaser

JG = JGrid(nz=48, nx=32, dz=0.25, dx=0.4, box_nz=16, box_nx=16)
TG = convert.grid_from(JG)


def _fields(seed=1, amp=0.1):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, amp, JG.shape).astype(np.float32) for _ in range(6)]


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_grid_geometry_and_box_of_position():
    assert (TG.n_boxes, TG.cells_per_box, TG.dt, TG.lz, TG.lx) == (
        JG.n_boxes, JG.cells_per_box, JG.dt, JG.lz, JG.lx,
    )
    np.testing.assert_array_equal(TG.box_coords, JG.box_coords)
    assert TG.box_neighbors == JG.box_neighbors
    rng = np.random.default_rng(0)
    # inside, on box edges, and outside the domain (clipped); negative
    # positions truncate toward zero
    z = np.concatenate([rng.uniform(-2, JG.lz + 2, 500), np.arange(4) * 16 * JG.dz]).astype(np.float32)
    x = np.concatenate([rng.uniform(-2, JG.lx + 2, 500), np.arange(4) * 16 * JG.dx]).astype(np.float32)
    ref = JG.box_of_position(jnp.asarray(z), jnp.asarray(x))
    got = TG.box_of_position(torch.from_numpy(z), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_shape_weights(order, offset):
    pos = np.random.default_rng(order).uniform(-1.0, 12.0, 1000).astype(np.float32)
    i_ref, w_ref = jshapes.shape_weights(jnp.asarray(pos), 0.274, offset, order)
    i_got, w_got = tshapes.shape_weights(torch.from_numpy(pos), 0.274, offset, order)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_ref))
    _close(w_got, w_ref, rtol=1e-6, atol=1e-7)


def test_field_updates_sponge_and_energy():
    comps = _fields()
    jf = jfields.Fields(*map(jnp.asarray, comps))
    tf = convert.fields_from(comps, "cpu")
    rng = np.random.default_rng(5)
    j = [rng.normal(0, 0.01, JG.shape).astype(np.float32) for _ in range(3)]
    ref = jfields.step_b_half(jfields.step_e(jf, tuple(map(jnp.asarray, j)), JG), JG)
    got = tfields.step_b_half(tfields.step_e(tf, tuple(map(torch.from_numpy, j)), TG), TG)
    for r, g in zip(ref, got):
        _close(g, r, rtol=1e-6, atol=1e-7)
    sponge_ref = jfields.make_sponge(JG, 8)
    sponge_got = tfields.make_sponge(TG, 8, device="cpu")
    _close(sponge_got, sponge_ref, rtol=1e-7)
    for r, g in zip(jfields.apply_sponge(jf, sponge_ref), tfields.apply_sponge(tf, sponge_got)):
        _close(g, r, rtol=1e-7)
    _close(tfields.field_energy(tf, TG), jfields.field_energy(jf, JG), rtol=1e-5)


@pytest.mark.parametrize("t", [3.0, 29.5])
def test_laser_inject(t):
    kw = dict(a0=25.0, waist=0.13 * JG.lx, duration=2.0, t_peak=4.0, z_pos=2.0, x_center=5.0)
    comps = _fields()
    ref = JLaser(**kw).inject(jfields.Fields(*map(jnp.asarray, comps)), JG, jnp.float32(t))
    got = TLaser(**kw).inject(
        convert.fields_from(comps, "cpu"), TG, torch.tensor(t, dtype=torch.float32)
    )
    for r, g in zip(ref, got):
        _close(g, r, rtol=1e-6, atol=1e-7)
    # the default ω0 keeps the reference's float32 square root
    assert TLaser().omega0 == JLaser().omega0


def test_gather_boris_move_and_kinetic_energy():
    jp = random_particles(400, JG, seed=11, u_scale=0.3)
    tp = convert.particles_from(jp, "cpu")
    comps = _fields()
    jf = jfields.Fields(*map(jnp.asarray, comps))
    tf = convert.fields_from(comps, "cpu")
    eb_ref = jpart.gather_fields(jf, jp.z, jp.x, JG, 3)
    eb_got = tpart.gather_fields(tf, tp.z, tp.x, TG, 3)
    for r, g in zip(eb_ref, eb_got):
        _close(g, r, rtol=2e-5, atol=1e-6)
    dt = float(JG.dt)
    ref = jpart.advance_positions(jpart.boris_push(jp, eb_ref, dt), JG, dt)
    # the port's own gather feeds its push: the chain is held end to end
    got = tpart.advance_positions(tpart.boris_push(tp, eb_got, dt), TG, dt)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    for name in ("ux", "uy", "uz"):
        _close(getattr(got, name), getattr(ref, name), rtol=2e-5, atol=1e-6)
    for name in ("z", "x"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-5, atol=1e-5)
    _close(tpart.kinetic_energy(got), jpart.kinetic_energy(ref), rtol=1e-5)


def test_deposit_current_and_box_accounting():
    jp = random_particles(600, JG, seed=13, u_scale=0.4)
    tp = convert.particles_from(jp, "cpu")
    for order in (1, 3):
        ref = jdep.deposit_current(jp, JG, order)
        got = tdep.deposit_current(tp, TG, order)
        for r, g in zip(ref, got):
            _close(g, r, rtol=0, atol=3e-4)
    counts_ref = jdep.box_particle_counts(jp, JG)
    counts_got = tdep.box_particle_counts(tp, TG)
    np.testing.assert_array_equal(counts_got.numpy(), np.asarray(counts_ref))
    n = np.array([0, 1, 255, 256, 257, 4096, 65536, 131072], np.float32)
    grid64 = JGrid(nz=512, nx=256, dz=0.274, dx=0.274, box_nz=64, box_nx=64)
    for jg in (JG, grid64):
        ref = np.asarray(jdep.box_work_counters(jnp.asarray(n), jg))
        got = tdep.box_work_counters(torch.from_numpy(n), convert.grid_from(jg)).numpy()
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
