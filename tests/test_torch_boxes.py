"""The port's box geometry, ring helpers and offset-aware laser injection
against the JAX package's.

Every numpy helper of ``repro_torch.pic.boxes`` and ``repro_torch.launch.
mesh`` must equal the reference's array for array (they are the sharded
runtime's routing tables); the laser profile and its time scale agree to
f32 rounding.
"""
import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro.pic import boxes as jboxes
from repro.pic.fields import Fields as JFields
from repro.pic.grid import Grid2D as JGrid
from repro.pic.laser import LaserAntenna as JLaser

from repro_torch import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.pic import boxes as tboxes
from repro_torch.pic.grid import Grid2D as TGrid

GRIDS = [
    pytest.param(dict(nz=16, nx=16, dz=0.5, dx=0.5, box_nz=8, box_nx=8), id="16sq"),
    pytest.param(dict(nz=32, nx=32, dz=0.5, dx=0.5, box_nz=8, box_nx=8), id="32sq"),
    pytest.param(dict(nz=24, nx=40, dz=0.3, dx=0.4, box_nz=8, box_nx=10), id="24x40"),
]
HALOS = [4, 5]


def _grids(kw):
    return JGrid(**kw), TGrid(**kw)


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("kw", GRIDS)
@pytest.mark.parametrize("plan", ["halo_paste_plan", "halo_fold_plan"])
def test_slice_plans_equal(plan, kw, halo):
    jg, tg = _grids(kw)
    assert getattr(tboxes, plan)(tg, halo) == getattr(jboxes, plan)(jg, halo)


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("kw", GRIDS)
def test_cell_maps_equal(kw, halo):
    jg, tg = _grids(kw)
    for name, args in (("interior_cell_map", ()), ("padded_cell_map", (halo,))):
        a = getattr(jboxes, name)(jg, *args)
        b = getattr(tboxes, name)(tg, *args)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("kw", GRIDS)
def test_halo_strip_tables_equal(kw, halo):
    jg, tg = _grids(kw)
    a, b = jboxes.halo_strip_tables(jg, halo), tboxes.halo_strip_tables(tg, halo)
    assert b.halo == a.halo and b.opposite == a.opposite
    np.testing.assert_array_equal(b.src_box, a.src_box)
    for field in ("paste_src", "paste_dst", "fold_src", "fold_dst"):
        for j, (x, y) in enumerate(zip(getattr(a, field), getattr(b, field))):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x, err_msg=f"{field}[{j}]")
    assert tboxes.HALO_DIRS == jboxes.HALO_DIRS


@pytest.mark.parametrize("layout", ["morton", "row"])
@pytest.mark.parametrize("kw", GRIDS)
def test_slot_layout_and_neighbours_equal(kw, layout):
    jg, tg = _grids(kw)
    np.testing.assert_array_equal(tboxes.box_slot_layout(tg, layout), jboxes.box_slot_layout(jg, layout))
    np.testing.assert_array_equal(tboxes.neighbor_box_table(tg), jboxes.neighbor_box_table(jg))


def test_bad_halo_and_layout_raise():
    _, tg = _grids(dict(nz=16, nx=16, dz=0.5, dx=0.5, box_nz=8, box_nx=8))
    for fn in (tboxes.halo_paste_plan, tboxes.halo_strip_tables):
        with pytest.raises(ValueError, match="halo"):
            fn(tg, 9)
    with pytest.raises(ValueError, match="layout"):
        tboxes.box_slot_layout(tg, "hilbert")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_helpers_equal(n):
    rng = np.random.default_rng(n)
    a, b = rng.integers(0, n, 64), rng.integers(0, n, 64)
    np.testing.assert_array_equal(tmesh.ring_offset(n, a, b), jmesh.ring_offset(n, a, b))
    np.testing.assert_array_equal(tmesh.ring_distance(n, a, b), jmesh.ring_distance(n, a, b))
    curve = rng.permutation(64)
    np.testing.assert_array_equal(
        tmesh.slot_home_devices(curve, n), jmesh.slot_home_devices(curve, n)
    )


def test_slot_home_devices_needs_equal_split():
    with pytest.raises(ValueError, match="evenly"):
        tmesh.slot_home_devices(np.arange(10), 4)


def test_make_box_mesh(monkeypatch):
    assert tmesh.make_box_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    assert tmesh.make_box_mesh(2, devices=["cpu", "cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(RuntimeError, match="devices"):
        tmesh.make_box_mesh(3, devices=["cpu"])
    # the default is CUDA, and without a CUDA device that raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_box_mesh(2)


@pytest.mark.parametrize("kw", GRIDS)
def test_laser_profile_equal(kw):
    jg, tg = _grids(kw)
    jl = JLaser(z_pos=1.0, x_center=3.0, waist=2.0)
    tl = convert.laser_from(jl)
    a = np.asarray(jl.profile(jg))
    b = tl.profile(tg).numpy()
    assert b.dtype == a.dtype
    np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("t", [3.0, 29.5, 41.25])
def test_laser_source_scale_and_inject_profile_equal(t):
    jg, tg = _grids(dict(nz=16, nx=16, dz=0.5, dx=0.5, box_nz=8, box_nx=8))
    jl = JLaser()
    tl = convert.laser_from(jl)
    tt = torch.full((), t, dtype=torch.float32)
    a = float(jl.source_scale(np.float32(t), jg.dt))
    b = float(tl.source_scale(tt, tg.dt))
    np.testing.assert_allclose(b, a, rtol=2e-6)

    rng = np.random.default_rng(7)
    comps = rng.standard_normal((6, 16, 16)).astype(np.float32)
    prof = np.asarray(jl.profile(jg))
    jf = jl.inject_profile(JFields(*comps), prof, jg, np.float32(t))
    tf = tl.inject_profile(convert.fields_from(comps, "cpu"), torch.from_numpy(prof.copy()), tg, tt)
    for name in ("ex", "ey", "ez", "bx", "by", "bz"):
        np.testing.assert_allclose(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), rtol=2e-6, atol=1e-6, err_msg=name
        )
