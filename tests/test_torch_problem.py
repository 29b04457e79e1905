"""The port's scenario registry against ``repro.pic.problem``.

Every builder draws from ``np.random.default_rng(seed)``, so the port's
initial species must equal the reference's bit for bit; grids and lasers
must be identical.  ``repro_torch.convert`` round-trips reference state.
"""
import numpy as np
import pytest

from repro.pic import problem as jproblem

from repro_torch import convert
from repro_torch.pic import problem as tproblem

SMALL = dict(nz=32, nx=32, box_cells=8, ppc=2, seed=3)


def test_same_registry():
    assert tproblem.list_scenarios() == jproblem.list_scenarios()
    for name in tproblem.list_scenarios():
        t, j = tproblem.get_scenario(name), jproblem.get_scenario(name)
        assert (t.imbalance, t.expect_noop, t.description) == (
            j.imbalance, j.expect_noop, j.description,
        )
    with pytest.raises(KeyError, match="unknown scenario"):
        tproblem.get_scenario("nope")


@pytest.mark.parametrize("name", jproblem.list_scenarios())
def test_initial_state_bitwise(name):
    ref = jproblem.get_scenario(name).build(**SMALL)
    got = tproblem.get_scenario(name).build(**SMALL, device="cpu")
    assert got.name == ref.name
    assert got.grid == convert.grid_from(ref.grid)
    assert got.laser == convert.laser_from(ref.laser)
    assert len(got.species) == len(ref.species)
    for gp, rp in zip(got.species, ref.species):
        leaves = convert.particles_to_numpy(gp)
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(rp, k)), err_msg=f"{name}.{k}")
            assert v.dtype == np.asarray(getattr(rp, k)).dtype


def test_convert_round_trip():
    ref = jproblem.laser_ion_problem(**SMALL)
    prob = convert.problem_from(ref, "cpu")
    assert prob.grid == convert.grid_from(ref.grid) and prob.name == ref.name
    for gp, rp in zip(prob.species, ref.species):
        for k, v in convert.particles_to_numpy(gp).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(rp, k)))
    rng = np.random.default_rng(0)
    comps = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(6)]
    back = convert.fields_to_numpy(convert.fields_from(comps, "cpu"))
    for c, k in zip(comps, ("ex", "ey", "ez", "bx", "by", "bz")):
        np.testing.assert_array_equal(back[k], c)
