"""The inputs come from the seed alone: bitwise the same for one seed, the
same sizes for every seed."""
import pytest
import torch

from _small import CONFIG, SEED
from portbench import inputs, spec


def _draw(workload, seed):
    cell = spec.load(workload)
    return inputs.draw(dict(cell.config, **CONFIG), seed, torch.device("cpu"))


@pytest.mark.parametrize("workload", ["laser_ion.sim", "uniform_plasma.sim"])
def test_same_seed_same_inputs(workload):
    a, b = _draw(workload, SEED), _draw(workload, SEED)
    c = _draw(workload, SEED + 1)
    assert a.geometry == b.geometry and a.laser == b.laser
    for sa, sb, sc in zip(a.species, b.species, c.species):
        for k in ("z", "x", "ux", "uy", "uz", "w"):
            assert torch.equal(sa[k], sb[k]), k
            assert sa[k].shape == sc[k].shape, k
        assert sa["q"] == sb["q"] and sa["m"] == sb["m"]
        assert not torch.equal(sa["z"], sc["z"])


@pytest.mark.parametrize("workload", ["laser_ion.sim", "uniform_plasma.sim"])
def test_particles_inside_the_domain(workload):
    p = _draw(workload, SEED)
    g = p.geometry
    for sp in p.species:
        assert bool(((sp["z"] >= 0) & (sp["z"] < g.lz) & (sp["x"] >= 0) & (sp["x"] < g.lx)).all())
        assert sp["z"].dtype == torch.float32


def test_large_seed_accepted():
    _draw("laser_ion.sim", 2**40 + 3)
