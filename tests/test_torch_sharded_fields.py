"""The port's block-sharded FDTD (``repro_torch.pic.sharded``) against the
reference's global field step, the counterpart of
``tests/test_sharded_fields.py:48``: the same seeded fields and currents,
five full leapfrog steps, on 1×1, 2×1 and 2×2 grids of logical CPU devices
(and 4×2, the reference test's mesh), max |Δ| < 1e-5.  The reference's own
``make_sharded_fdtd_step`` runs on its one CPU device as a 1×1 mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pic import Grid2D as JGrid
from repro.pic.fields import Fields as JFields
from repro.pic.fields import step_b_half as j_b_half
from repro.pic.fields import step_e as j_e
from repro.pic.sharded import make_sharded_fdtd_step as j_sharded_step

from repro_torch.pic import Grid2D
from repro_torch.pic.fields import Fields
from repro_torch.pic.sharded import field_shardings, make_sharded_fdtd_step

GRID = dict(nz=64, nx=32, dz=0.3, dx=0.25, box_nz=16, box_nx=16)
STEPS = 5


def _inputs():
    rng = np.random.default_rng(0)
    f0 = [rng.normal(0, 1, (GRID["nz"], GRID["nx"])).astype(np.float32) for _ in range(6)]
    j = [rng.normal(0, 0.1, (GRID["nz"], GRID["nx"])).astype(np.float32) for _ in range(3)]
    return f0, j


def _reference_global(f0, j):
    grid = JGrid(**GRID)
    f = JFields(*(jnp.asarray(c) for c in f0))
    jj = tuple(jnp.asarray(c) for c in j)
    for _ in range(STEPS):
        f = j_b_half(f, grid)
        f = j_e(f, jj, grid)
        f = j_b_half(f, grid)
    return [np.asarray(c) for c in f]


def _port(f0, j, pz, px):
    mesh = [["cpu"] * px for _ in range(pz)]
    step, shardings = make_sharded_fdtd_step(Grid2D(**GRID), mesh)
    f = Fields(*(shardings.split(torch.from_numpy(c)) for c in f0))
    jj = tuple(shardings.split(torch.from_numpy(c)) for c in j)
    for _ in range(STEPS):
        f = step(f, jj)
    assert all(len(c) == pz and len(c[0]) == px for c in f)
    return [shardings.join(c).numpy() for c in f]


@pytest.mark.parametrize("pz,px", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_sharded_fdtd_matches_reference_global(pz, px):
    f0, j = _inputs()
    ref = _reference_global(f0, j)
    got = _port(f0, j, pz, px)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, ref)) < 1e-5


def test_matches_reference_sharded_step_on_one_device():
    f0, j = _inputs()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step, sharding = j_sharded_step(JGrid(**GRID), mesh)
    f = JFields(*(jax.device_put(jnp.asarray(c), sharding) for c in f0))
    jj = tuple(jax.device_put(jnp.asarray(c), sharding) for c in j)
    for _ in range(STEPS):
        f = step(f, jj)
    got = _port(f0, j, 2, 2)
    assert max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(got, f)) < 1e-5


def test_split_join_roundtrip_and_errors():
    t = torch.arange(GRID["nz"] * GRID["nx"], dtype=torch.float32).view(GRID["nz"], GRID["nx"])
    sh = field_shardings(Grid2D(**GRID), [["cpu", "cpu"], ["cpu", "cpu"]])
    blocks = sh.split(t)
    assert blocks[1][0].shape == (32, 16) and blocks[1][0][0, 0] == t[32, 0]
    assert torch.equal(sh.join(blocks), t)
    with pytest.raises(ValueError, match="split"):
        field_shardings(Grid2D(**GRID), [["cpu"] * 3])
    with pytest.raises(ValueError, match="mesh"):
        field_shardings(Grid2D(**GRID), [["cpu", "cpu"], ["cpu"]])
