"""Split-phase stepping (``ShardedRuntime(overlap=True)``) in the port,
against the reference's and against the port's monolithic step.

  * geometry: ``frontier_cell_mask`` equals the reference's at box sizes 8,
    16 and 32, and raises on an unknown order as it does;
  * the split phases: ``particle_phase_stacked_frontier`` and
    ``particle_phase_stacked_interior`` against the reference's on the same
    slot stacks (flags exact, deposits within 2e-5·max|ref|, particle state
    rtol 2e-5), and frontier + interior against the monolithic deposit;
  * the runtime: overlap against the reference's ``overlap=True`` on one
    device in process, both ``comm`` modes and both pipelines (``test_torch_sharded.
    assert_matches``; 2 and 4 devices through an adoption are in
    ``test_torch_sharded_multi.py``), and against the port's own
    ``overlap=False`` at 1, 2 and 4 logical devices (fields within
    1e-5·max, census and drops exact);
  * the window: ``interval_trace`` spans in the order ``split_phase_order``
    checks, and the check fails on traces that break it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sharded as oracle
from repro.pic import engine as jengine
from repro.pic.boxes import frontier_cell_mask as j_mask
from repro.pic.grid import Grid2D as JGrid
from repro.pic.particles import Particles as JParticles

from repro_torch import convert
from repro_torch.dist import ShardedRuntime, split_phase_order
from repro_torch.pic import engine as tengine
from repro_torch.pic import laser_ion_problem
from repro_torch.pic.boxes import frontier_cell_mask as t_mask
from repro_torch.pic.grid import Grid2D as TGrid

HALO = 4


def _grid_kw(box):
    return dict(nz=2 * box, nx=2 * box, dz=0.3, dx=0.3, box_nz=box, box_nx=box)


@pytest.mark.parametrize("box", [8, 16, 32])
def test_frontier_mask_matches_reference(box):
    got = t_mask(TGrid(**_grid_kw(box)), HALO, 3)
    want = j_mask(JGrid(**_grid_kw(box)), HALO, 3)
    np.testing.assert_array_equal(got, want)
    assert got.all() == (box == 8)  # 8-cell boxes have no interior band
    np.testing.assert_array_equal(t_mask(TGrid(**_grid_kw(box)), HALO, 1),
                                  j_mask(JGrid(**_grid_kw(box)), HALO, 1))


def test_frontier_mask_rejects_unknown_order():
    with pytest.raises(ValueError):
        j_mask(JGrid(**_grid_kw(16)), HALO, 2)
    with pytest.raises(ValueError):
        t_mask(TGrid(**_grid_kw(16)), HALO, 2)


def _stacks(box=16, cap=96, seed=0):
    """Numpy slot stacks of two species on the four boxes of a (2 box)²
    grid: particles spread over each box, a share within a cell of its
    edges, some slots partly empty."""
    kw = _grid_kw(box)
    grid = JGrid(**kw)
    rng = np.random.default_rng(seed)
    S = grid.n_boxes
    lb = box * kw["dz"]
    pn = box + 2 * HALO
    species = []
    for s, (q, m) in enumerate(((-1.0, 1.0), (1.0, 100.0))):
        z = np.empty((S, cap), np.float32)
        x = np.empty((S, cap), np.float32)
        for b, (bz, bx) in enumerate(np.asarray(grid.box_coords)):
            frac = rng.uniform(0.0, 1.0, (2, cap))
            frac[:, : cap // 4] = rng.choice([0.01, 0.99], (2, cap // 4))  # near the edges
            z[b] = bz * lb + frac[0] * lb
            x[b] = bx * lb + frac[1] * lb
        u = (rng.standard_normal((3, S, cap)) * 0.2).astype(np.float32)
        counts = rng.integers(cap // 2, cap + 1, S)
        counts[s] = 0  # an empty slot per species
        species.append(dict(
            z=z, x=x, ux=u[0], uy=u[1], uz=u[2],
            w=rng.uniform(0.5, 1.5, (S, cap)).astype(np.float32),
            alive=np.arange(cap)[None, :] < counts[:, None],
            q=np.float32(q), m=np.float32(m),
        ))
    origins = np.stack([[(bz * box - HALO) * kw["dz"], (bx * box - HALO) * kw["dx"]]
                        for bz, bx in np.asarray(grid.box_coords)]).astype(np.float32)
    tiles6 = (rng.standard_normal((S, 6, pn, pn)) * 0.05).astype(np.float32)
    local = dict(nz=pn, nx=pn, dz=kw["dz"], dx=kw["dx"], box_nz=pn, box_nx=pn)
    return kw, local, species, origins, tiles6


def _close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    assert np.abs(a - b).max(initial=0.0) <= 2e-5 * max(np.abs(b).max(initial=0.0), 1e-30), name


def test_split_phases_match_reference():
    kw, local, species, origins, tiles6 = _stacks()
    mask = j_mask(JGrid(**kw), HALO, 3)
    j_sp, j_jf, j_counts, j_flags = jengine.particle_phase_stacked_frontier(
        jnp.asarray(tiles6), tuple(JParticles(**{k: jnp.asarray(v) for k, v in sp.items()})
                                   for sp in species),
        jnp.asarray(origins), JGrid(**local), domain_grid=JGrid(**kw), shape_order=3,
        frontier_mask=jnp.asarray(mask),
    )
    j_ji = jengine.particle_phase_stacked_interior(
        j_sp, jnp.asarray(origins), JGrid(**local), shape_order=3, frontier_flags=j_flags,
    )
    t_in = tuple(convert.particles_from(type("P", (), sp), "cpu") for sp in species)
    t_sp, t_jf, t_counts, t_flags = tengine.particle_phase_stacked_frontier(
        torch.from_numpy(tiles6), t_in, torch.from_numpy(origins), TGrid(**local),
        domain_grid=TGrid(**kw), shape_order=3, frontier_mask=torch.from_numpy(mask),
    )
    t_ji = tengine.particle_phase_stacked_interior(
        t_sp, torch.from_numpy(origins), TGrid(**local), shape_order=3, frontier_flags=t_flags,
    )
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    for a, b in zip(t_flags, j_flags):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < sum(int(f.sum()) for f in t_flags) < sum(f.numel() for f in t_flags)
    _close(t_jf.numpy(), j_jf, "j3 frontier")
    _close(t_ji.numpy(), j_ji, "j3 interior")
    for a, b in zip(t_sp, j_sp):
        for k in ("z", "x", "ux", "uy", "uz"):
            np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)),
                                       rtol=2e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(a.alive.numpy(), np.asarray(b.alive))
    # the split reorders the per-cell sums of the monolithic pass, nothing else
    m_sp, m_j3, m_counts = tengine.particle_phase_stacked(
        torch.from_numpy(tiles6), t_in, torch.from_numpy(origins), TGrid(**local),
        domain_grid=TGrid(**kw), shape_order=3,
    )
    np.testing.assert_array_equal(m_counts.numpy(), t_counts.numpy())
    _close((t_jf + t_ji).numpy(), m_j3.numpy(), "frontier + interior vs monolithic")
    for a, b in zip(t_sp, m_sp):
        for k in ("z", "x", "ux", "uy", "uz", "alive"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def _spec(comm, n=1, script=(("run", 6),), **kw):
    kw = dict(dict(comm=comm, lb_interval=3, overlap=True, improvement_threshold=0.0), **kw)
    return ("split", n, kw, list(script))


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_overlap_matches_reference_1_device(comm):
    spec = _spec(comm)
    oracle.assert_matches(oracle.port(spec, "torch"), oracle.reference(spec))


def _physics(rt):
    return np.stack([np.asarray(c) for c in rt.fields]), rt.total_alive(), rt.dropped_total


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_overlap_matches_monolithic(n, comm):
    """Through a forced adoption and the gate left open, as the reference's
    own equality tests run."""
    out = {}
    for overlap in (False, True):
        rt, _ = oracle.port_run(
            _spec(comm, n, [("run", 3), ("force",), ("run", 6)], overlap=overlap), "torch"
        )
        out[overlap] = _physics(rt)
    (f_ser, n_ser, d_ser), (f_ovl, n_ovl, d_ovl) = out[False], out[True]
    assert np.abs(f_ovl - f_ser).max() <= 1e-5 * max(np.abs(f_ser).max(), 1e-30)
    assert n_ovl == n_ser and d_ovl == d_ser == 0


def _runtime(comm, n, overlap=True):
    return ShardedRuntime(
        laser_ion_problem(**oracle.SPLIT, device="cpu"), n, lb_interval=2, comm=comm,
        overlap=overlap, engine_backend="torch", device="cpu",
    )


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_interval_trace_order(comm):
    rt = _runtime(comm, 2)
    spans = rt.interval_trace()
    assert rt.step_idx == 2  # the traced interval ran and was committed
    names = [s[0] for s in spans]
    per_step = ["split_phase:frontier:d0", "split_phase:frontier:d1",
                "split_phase:exchange_start",
                "split_phase:interior:d0", "split_phase:interior:d1",
                "split_phase:exchange_done",
                "split_phase:fold:d0", "split_phase:fold:d1"]
    assert names == per_step * 2
    assert split_phase_order(spans, 2) == []


def test_order_check_catches_a_broken_window():
    spans = _runtime("neighbor", 2).interval_trace()
    # an arrival folded before the interior deposit: swap the two spans
    by = {name: i for i, (name, _, _) in enumerate(spans[:8])}
    broken = list(spans)
    it, fo = by["split_phase:interior:d1"], by["split_phase:fold:d1"]
    broken[it] = (spans[it][0], spans[fo][1] + 1.0, spans[fo][1] + 2.0)
    assert any("folded before" in v for v in split_phase_order(broken, 2))
    assert any("exchange done" in v for v in split_phase_order(broken, 2))
    # a monolithic runtime issues no split-phase spans
    mono = _runtime("neighbor", 2, overlap=False).interval_trace()
    assert mono == [] and split_phase_order(mono, 2)


def test_cuda_backend_with_overlap_raises():
    with pytest.raises(ValueError, match="overlap"):
        ShardedRuntime(laser_ion_problem(**oracle.SPLIT, device="cpu"), 1, overlap=True,
                       engine_backend="cuda", device="cpu")


@pytest.mark.parametrize("comm", ["neighbor", "ring"])
def test_overlap_under_async_matches_reference_async(comm):
    """The split step is the same under ``pipeline="async"``: held to the
    reference's async overlap run on one device, through the adoptions the
    open gate makes."""
    spec = _spec(comm, pipeline="async")
    oracle.assert_matches(oracle.port(spec, "torch"), oracle.reference(spec))
