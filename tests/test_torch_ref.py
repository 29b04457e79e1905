"""The port's kernel oracles (``repro_torch.kernels.ref``) against the
reference's (``repro.kernels.ref``).

``work_counters_ref`` exact and ``deposit_local_tiles_ref`` within
2e-5·max|J| of the reference on the same numpy inputs (the binned
layout of the reference's ``random_particles`` and ``bin_particles``);
the counters also match the port's ``box_work_counters`` formula and the
tiles the plain deposition of ``repro_torch.kernels.deposition``.
``random_particles`` draws from a torch generator, so it is held to the
reference's contract (positions inside ``margin``, momenta of std
``u_scale``, weights in [0.5, 1.5), ~10% dead), not to its values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import deposit_local_tiles_ref as ref_deposit
from repro.kernels.ref import random_particles as ref_random_particles
from repro.kernels.ref import work_counters_ref as ref_counters
from repro.pic import Grid2D as RefGrid2D
from repro_torch.convert import grid_from
from repro_torch.kernels.deposition import deposit_local_tiles
from repro_torch.kernels.ref import deposit_local_tiles_ref, random_particles, work_counters_ref
from repro_torch.pic.deposition import box_work_counters

GRIDS = [
    RefGrid2D(nz=32, nx=32, dz=0.3, dx=0.3, box_nz=16, box_nx=16),  # 4 boxes
    RefGrid2D(nz=48, nx=32, dz=0.25, dx=0.4, box_nz=16, box_nx=16),  # anisotropic, 6 boxes
    RefGrid2D(nz=32, nx=32, dz=0.3, dx=0.3, box_nz=8, box_nx=8),  # 16 small boxes
]


def _binned_inputs(grid, n, tile):
    """The deposition inputs of ``tests/test_kernels.py``, as numpy."""
    p = ref_random_particles(max(n, 1), grid, seed=n + grid.nz)
    if n == 0:
        p = p._replace(alive=jnp.zeros(p.n, bool))
    cap = 4 * tile
    b = ref_ops.bin_particles(p, grid, cap)
    gamma = jnp.sqrt(1.0 + b.ux ** 2 + b.uy ** 2 + b.uz ** 2)
    live = jnp.arange(cap)[None, :] < b.counts[:, None]
    coef = jnp.where(live, -1.0 * b.w, 0.0) / (gamma * grid.dz * grid.dx)
    args = (b.counts, b.sz, b.sx, coef * b.ux, coef * b.uy, coef * b.uz)
    return [np.array(a) for a in args]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
@pytest.mark.parametrize("n,tile", [(700, 128), (123, 64), (0, 64)])
def test_deposit_oracle_matches_reference(grid, n, tile):
    ref_grid = GRIDS[grid]
    args = _binned_inputs(ref_grid, n, tile)
    want = ref_deposit(*(jnp.asarray(a) for a in args), grid=ref_grid, tile=tile)
    port_grid = grid_from(ref_grid)
    got = deposit_local_tiles_ref(*(torch.from_numpy(a) for a in args), grid=port_grid, tile=tile)
    plain = deposit_local_tiles(*(torch.from_numpy(a) for a in args), grid=port_grid, tile=tile)
    for g, w, k in zip(got[:3], want[:3], plain[:3]):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * scale, rtol=0)
        np.testing.assert_allclose(k.numpy(), g.numpy(), atol=2e-5 * scale, rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(plain[3].numpy(), got[3].numpy())


@pytest.mark.parametrize("which", ["deposit", "push", "both"])
@pytest.mark.parametrize("tile", [64, 256])
def test_work_counters_match_reference(which, tile):
    ref_grid = GRIDS[2]
    counts = np.array([0, 1, 63, 64, 65, 255, 256, 257, 511, 1000, 3, 0, 17, 128, 129, 2048],
                      np.int32)
    want = np.asarray(ref_counters(jnp.asarray(counts), ref_grid, tile=tile, which=which))
    got = work_counters_ref(torch.from_numpy(counts), grid_from(ref_grid), tile=tile, which=which)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if which == "both" and tile == 256:
        np.testing.assert_array_equal(
            box_work_counters(torch.from_numpy(counts), grid_from(ref_grid)).numpy(), want)


@pytest.mark.parametrize("margin,u_scale", [(3.0, 0.5), (1.0, 0.3)])
def test_random_particles_contract(margin, u_scale):
    grid = grid_from(GRIDS[1])
    n = 20_000
    p = random_particles(n, grid, seed=5, margin=margin, u_scale=u_scale, device="cpu")
    for leaf in (p.z, p.x, p.ux, p.uy, p.uz, p.w):
        assert leaf.shape == (n,) and leaf.dtype == torch.float32
    assert p.alive.dtype == torch.bool
    assert float(p.z.min()) >= margin and float(p.z.max()) <= grid.lz - margin
    assert float(p.x.min()) >= margin and float(p.x.max()) <= grid.lx - margin
    for u in (p.ux, p.uy, p.uz):
        assert abs(float(u.std()) / u_scale - 1.0) < 0.03
        assert abs(float(u.mean())) < 0.03 * u_scale
    assert float(p.w.min()) >= 0.5 and float(p.w.max()) < 1.5
    assert 0.88 < float(p.alive.float().mean()) < 0.92
    assert float(p.q) == -1.0 and float(p.m) == 1.0
    again = random_particles(n, grid, seed=5, margin=margin, u_scale=u_scale, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p, again))
