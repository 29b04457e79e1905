"""The port's kernel layer against the JAX kernels (Pallas in interpret mode).

On CPU tensors the wrappers run the kernels' plain PyTorch versions, so
these tests hold the plain versions to the TPU kernels' contract; the CUDA
kernels are held to the plain versions on the card by ``chip_smoke.py``.

Tolerances: pushed state rtol 2e-5 / atol 1e-6 (``tests/test_kernels.py``),
J atol 2e-5·max|J| (f32 rounding of a different sum order), counters,
censuses, slots and drop counts exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.deposition import deposit_local_tiles as j_deposit
from repro.kernels.gather_push import gather_push_move as j_gather_push
from repro.kernels.ref import random_particles
from repro.pic.fields import Fields as JFields
from repro.pic.grid import Grid2D as JGrid

from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels._tensors import span_table
from repro_torch.kernels.deposition import deposit_local_tiles as t_deposit
from repro_torch.kernels.deposition import deposition_launcher
from repro_torch.kernels.gather_push import gather_push_move as t_gather_push
from repro_torch.kernels.gather_push import gather_push_launcher
from repro_torch.kernels.gather_push import gather_push_move_ as t_gather_push_
from repro_torch.pic.deposition import box_work_counters
from repro_torch.pic.grid import Grid2D as TGrid

HALO = 3
CAP = 512

ADVERSARIAL = [
    pytest.param([0, 0, 0, 0], "interior", id="all-empty"),
    pytest.param([512, 0, 0, 0], "interior", id="all-in-one-box"),
    pytest.param([512, 512, 512, 512], "interior", id="at-capacity"),
    pytest.param([1, 255, 256, 257], "interior", id="tile-boundaries"),
    pytest.param([137, 256, 0, 490], "edges", id="box-edge-seam"),
]


def _grids():
    kw = dict(nz=16, nx=16, dz=0.5, dx=0.5, box_nz=8, box_nx=8)
    return JGrid(**kw), TGrid(**kw)


def _binned(counts, spread, pad=0, seed=0):
    """Binned kernel inputs: live lanes inside (or hugging the edges of)
    their box in local cell units; padding lanes at s=0 with nonzero values
    (their stencils leave the tile); lanes past the last chunk hold noise."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    B = len(counts)
    lo = HALO + pad
    if spread == "edges":
        edge = rng.uniform(-1.0, 1.0, (B, CAP))
        side = rng.integers(0, 4, (B, CAP))
        along = rng.uniform(0, 8, (B, CAP))
        sz = np.where(side == 0, lo + edge, np.where(side == 1, lo + 8 - edge, lo + along))
        sx = np.where(side == 2, lo + edge, np.where(side == 3, lo + 8 - edge, lo + along))
    else:
        sz = lo + rng.uniform(0.05, 0.95, (B, CAP)) * 8
        sx = lo + rng.uniform(0.05, 0.95, (B, CAP)) * 8
    live = np.arange(CAP)[None, :] < counts[:, None]
    executed = np.arange(CAP)[None, :] < ((counts[:, None] + 255) // 256) * 256
    pad_lane = executed & ~live
    sz = np.where(pad_lane, 0.0, sz).astype(np.float32)
    sx = np.where(pad_lane, 0.0, sx).astype(np.float32)
    vel = rng.normal(0, 0.3, (3, B, CAP)).astype(np.float32)
    n = 8 + 2 * HALO + 2 * pad
    tiles = rng.normal(0, 0.1, (6, B, n, n)).astype(np.float32)
    return counts, sz, sx, vel, tiles


def _to_t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_gather_push_plain_matches_pallas(counts, spread):
    jg, tg = _grids()
    counts, sz, sx, vel, tiles = _binned(counts, spread)
    dt = float(jg.dt)
    ref = j_gather_push(
        jnp.asarray(counts), jnp.asarray(sz), jnp.asarray(sx), *map(jnp.asarray, vel),
        tuple(jnp.asarray(t) for t in tiles), grid=jg, qm=-1.0, dt=dt, interpret=True,
    )
    got = t_gather_push(
        _to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), tuple(map(_to_t, tiles)),
        grid=tg, qm=torch.tensor(-1.0), dt=dt,
    )
    for r, g in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=1e-6)
    # lanes of chunks that did not run pass through bit for bit
    skipped = np.arange(CAP)[None, :] >= ((counts[:, None] + 255) // 256) * 256
    np.testing.assert_array_equal(got[0].numpy()[skipped], sz[skipped])
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_gather_push_in_place_matches_functional_and_pallas(counts, spread):
    """``gather_push_move_`` updates its five arrays to what the JAX
    function returns, equals the functional form bitwise, returns only the
    counters, and leaves every lane past the last executed chunk as it was."""
    jg, tg = _grids()
    counts, sz, sx, vel, tiles = _binned(counts, spread, seed=3)
    dt = float(jg.dt)
    ref = j_gather_push(
        jnp.asarray(counts), jnp.asarray(sz), jnp.asarray(sx), *map(jnp.asarray, vel),
        tuple(jnp.asarray(t) for t in tiles), grid=jg, qm=-1.0, dt=dt, interpret=True,
    )
    kw = dict(grid=tg, qm=torch.tensor(-1.0), dt=dt)
    functional = t_gather_push(
        _to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), tuple(map(_to_t, tiles)), **kw
    )
    before = [sz, sx, *vel]
    arrays = [_to_t(a).clone() for a in before]
    cnt = t_gather_push_(_to_t(counts), *arrays, tuple(map(_to_t, tiles)), **kw)
    assert cnt.shape == (len(counts),) and cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[5]))
    skipped = np.arange(CAP)[None, :] >= ((counts[:, None] + 255) // 256) * 256
    for a, f, r, old in zip(arrays, functional[:5], ref[:5], before):
        assert torch.equal(a.view(torch.int32), f.view(torch.int32))
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(
            a.numpy().view(np.int32)[skipped], old.view(np.int32)[skipped]
        )
    if counts.any():  # the executed lanes moved: the inputs were updated
        assert not np.array_equal(arrays[0].numpy(), sz)


def _span_mirror(counts, cap, tile, g):
    """numpy mirror of the span table and of the kernels' walk over it
    (csrc/common.cuh: span_at, block_spans); the CUDA walk itself runs
    only on the card, where chip_smoke.py launches both kernels with spans
    of 1, 8 and cap/tile chunks."""
    chunks = np.minimum(np.maximum((counts.astype(np.int64) + tile - 1) // tile, 0), cap // tile)
    table = np.concatenate([[0], np.cumsum((chunks + g - 1) // g)]).astype(np.int32)

    def span_at(s, hint):
        lo = hint
        if hint < 0 or table[hint] > s or table[hint + 1] <= s:
            lo, hi = 0, len(counts)
            while hi - lo > 1:
                mid = (lo + hi) >> 1
                lo, hi = (mid, hi) if table[mid] <= s else (lo, mid)
        c0 = (s - table[lo]) * g
        return lo, c0, min(c0 + g, chunks[lo])

    return chunks, table, span_at


_SPAN_CAP = 64 * 256
SPAN_CASES = [pytest.param(p.values[0], CAP, id=p.id) for p in ADVERSARIAL] + [
    pytest.param([8 * 256 - 1, 8 * 256, 8 * 256 + 1, _SPAN_CAP], _SPAN_CAP, id="span-boundaries"),
    pytest.param([0, 0, 0, 0, 0, 5000], _SPAN_CAP, id="last-box-only"),
    pytest.param([3000, 0, _SPAN_CAP, 0, 1, 0, 9000], _SPAN_CAP, id="alternate-empty"),
]


@pytest.mark.parametrize("group", [1, 8, "cap/tile"])
@pytest.mark.parametrize("counts,cap", SPAN_CASES)
def test_span_table_covers_every_executed_chunk_once(counts, cap, group):
    tile = 256
    g = cap // tile if group == "cap/tile" else group
    counts = np.asarray(counts, np.int32)
    chunks, table, span_at = _span_mirror(counts, cap, tile, g)
    got = span_table(torch.from_numpy(counts), cap, tile, span_chunks=g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), table)
    executed = np.arange(cap // tile)[None, :] < chunks[:, None]
    for n_blocks in (1, 3, 264):
        covered = np.zeros(executed.shape, np.int64)
        total = int(table[-1])
        for blk in range(n_blocks):
            first, last = total * blk // n_blocks, total * (blk + 1) // n_blocks
            box = -1
            for s in range(first, last):
                box, c0, c1 = span_at(s, box)
                assert 0 < c1 - c0 <= g
                covered[box, c0:c1] += 1
        np.testing.assert_array_equal(covered, executed.astype(np.int64))


def test_launchers_refuse_cpu_tensors():
    """The launchers prepare only a CUDA launch: on CPU tensors they raise
    instead of running anything (the public wrappers run the plain versions)."""
    _, tg = _grids()
    counts, sz, sx, vel, tiles = _binned([3, 0, 0, 0], "interior")
    arrays = [_to_t(a) for a in (sz, sx, *vel)]
    with pytest.raises(ValueError, match="cuda"):
        gather_push_launcher(
            _to_t(counts), arrays, tuple(map(_to_t, tiles)), grid=tg, qm=-1.0, dt=float(tg.dt)
        )
    with pytest.raises(ValueError, match="cuda"):
        deposition_launcher(_to_t(counts), *arrays, grid=tg)


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_deposition_plain_matches_pallas(counts, spread):
    jg, tg = _grids()
    counts, sz, sx, vel, _ = _binned(counts, spread)
    ref = j_deposit(
        jnp.asarray(counts), jnp.asarray(sz), jnp.asarray(sx), *map(jnp.asarray, vel),
        grid=jg, interpret=True,
    )
    got = t_deposit(_to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), grid=tg)
    scale = max(float(np.abs(np.asarray(ref[0])).max()), 1e-30)
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5 * scale)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("counts,spread", ADVERSARIAL)
def test_plain_counters_sum_to_formula_bitwise(counts, spread):
    _, tg = _grids()
    counts, sz, sx, vel, tiles = _binned(counts, spread)
    *_, c_push = t_gather_push(
        _to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), tuple(map(_to_t, tiles)),
        grid=tg, qm=-1.0, dt=0.1,
    )
    *_, c_dep = t_deposit(_to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), grid=tg)
    total = (c_push + c_dep).to(torch.float32)
    expect = box_work_counters(_to_t(counts).float(), tg)
    assert torch.equal(total, expect)


def test_tile_shape_and_cells_per_box_overrides():
    """Wider padded tiles (the sharded runtime's) with the counter's cell
    term pinned to the domain box."""
    jg, tg = _grids()
    pad = 2
    counts, sz, sx, vel, tiles = _binned([137, 256, 0, 490], "edges", pad=pad)
    shape = (8 + 2 * HALO + 2 * pad,) * 2
    dt = float(jg.dt)
    ref = j_deposit(
        jnp.asarray(counts), jnp.asarray(sz), jnp.asarray(sx), *map(jnp.asarray, vel),
        grid=jg, interpret=True, tile_shape=shape, cells_per_box=64,
    )
    got = t_deposit(
        _to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel),
        grid=tg, tile_shape=shape, cells_per_box=64,
    )
    scale = float(np.abs(np.asarray(ref[0])).max())
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5 * scale)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    ref_g = j_gather_push(
        jnp.asarray(counts), jnp.asarray(sz), jnp.asarray(sx), *map(jnp.asarray, vel),
        tuple(jnp.asarray(t) for t in tiles), grid=jg, qm=-1.0, dt=dt, interpret=True,
        tile_shape=shape,
    )
    got_g = t_gather_push(
        _to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), tuple(map(_to_t, tiles)),
        grid=tg, qm=-1.0, dt=dt, tile_shape=shape,
    )
    for r, g in zip(ref_g[:5], got_g[:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(got_g[5].numpy(), np.asarray(ref_g[5]))


def test_wrapper_refuses_misshapen_input():
    _, tg = _grids()
    counts, sz, sx, vel, _ = _binned([1, 2, 3, 4], "interior")
    with pytest.raises(ValueError, match="multiple of tile"):
        t_deposit(_to_t(counts), _to_t(sz), _to_t(sx), *map(_to_t, vel), grid=tg, tile=300)
    with pytest.raises(ValueError, match="float32"):
        t_deposit(
            _to_t(counts), _to_t(sz).double(), _to_t(sx), *map(_to_t, vel), grid=tg
        )


# ---------------------------------------------------------------------------
# the glue around the kernels
# ---------------------------------------------------------------------------


def _random_fields(grid, seed=1, amp=0.1):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, amp, grid.shape).astype(np.float32) for _ in range(6)]


@pytest.mark.parametrize("cap", [256, 16])
def test_bin_particles_matches_reference(cap):
    jg, tg = _grids()
    jp = random_particles(300, jg, seed=17)
    ref = jops.bin_particles(jp, jg, cap)
    got = tops.bin_particles(convert.particles_from(jp, "cpu"), tg, cap)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.n_dropped) == int(ref.n_dropped)
    if cap == 16:
        assert int(got.n_dropped) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(
        got.slot_of_particle.numpy()[valid], np.asarray(ref.slot_of_particle)[valid]
    )
    for name in ("sz", "sx", "ux", "uy", "uz", "w"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )


def test_field_tiles_and_assemble_grid_match_reference():
    jg = JGrid(nz=32, nx=32, dz=0.3, dx=0.3, box_nz=8, box_nx=8)
    tg = convert.grid_from(jg)
    comps = _random_fields(jg)
    ref_tiles = jops.field_tiles(JFields(*map(jnp.asarray, comps)), jg)
    got_tiles = tops.field_tiles(convert.fields_from(comps, "cpu"), tg)
    for r, g in zip(ref_tiles, got_tiles):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref_back = jops.assemble_grid(ref_tiles[0], jg)
    got_back = tops.assemble_grid(got_tiles[0], tg)
    np.testing.assert_allclose(got_back.numpy(), np.asarray(ref_back), rtol=1e-6, atol=1e-7)


def test_pic_substep_body_matches_reference():
    jg = JGrid(nz=32, nx=32, dz=0.3, dx=0.3, box_nz=8, box_nx=8)
    tg = convert.grid_from(jg)
    jp = random_particles(600, jg, seed=13, u_scale=0.4)
    comps = _random_fields(jg)
    dt = float(jg.dt)
    r_p, r_j, r_cnt, r_counts, r_nd = jops.pic_substep_body(
        JFields(*map(jnp.asarray, comps)), jp, grid=jg, dt=dt, cap=512, interpret=True
    )
    g_p, g_j, g_cnt, g_counts, g_nd = tops.pic_substep_body(
        convert.fields_from(comps, "cpu"), convert.particles_from(jp, "cpu"),
        grid=tg, dt=dt, cap=512,
    )
    np.testing.assert_array_equal(g_counts.numpy(), np.asarray(r_counts))
    np.testing.assert_array_equal(g_cnt.numpy(), np.asarray(r_cnt))
    assert int(g_nd) == int(r_nd) == 0
    np.testing.assert_array_equal(g_p.alive.numpy(), np.asarray(r_p.alive))
    for name in ("z", "x"):
        np.testing.assert_allclose(
            getattr(g_p, name).numpy(), np.asarray(getattr(r_p, name)), rtol=1e-5, atol=1e-5
        )
    for name in ("ux", "uy", "uz"):
        np.testing.assert_allclose(
            getattr(g_p, name).numpy(), np.asarray(getattr(r_p, name)), rtol=2e-5, atol=1e-6
        )
    for r, g in zip(r_j, g_j):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5 * scale)
