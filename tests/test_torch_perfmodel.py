"""The port's ``repro_torch.core.perfmodel`` against ``repro.core.perfmodel``.

Every function on seeded inputs gives the reference's float64 result
exactly (both are the same numpy arithmetic), and both raise on the same
invalid inputs.
"""
import numpy as np
import pytest

from repro.core import perfmodel as jpm

from repro_torch.core import perfmodel as tpm


def _samples(seed):
    rng = np.random.default_rng(seed)
    n = np.sort(rng.integers(1, 512, 6)).astype(np.float64) + np.arange(6)
    x = rng.uniform(0.5, 1.0)
    t = 1e3 * n ** (-x) * rng.lognormal(0.0, 0.05, 6)
    return n, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_and_model_match(seed):
    n, t = _samples(seed)
    assert tpm.fit_strong_scaling(n, t) == jpm.fit_strong_scaling(n, t)
    a, b = tpm.StrongScalingModel.fit(n, t), jpm.StrongScalingModel.fit(n, t)
    assert (a.x, a.A) == (b.x, b.A)
    for nodes in (1, 3.5, 64, 4096):
        assert a.walltime(nodes) == b.walltime(nodes)
    for e0 in (0.2, 0.5, 0.9, 1.0):
        assert a.max_speedup(e0) == b.max_speedup(e0)
        assert a.attained_fraction(1.3, e0) == b.attained_fraction(1.3, e0)


@pytest.mark.parametrize("seed", [0, 1])
def test_speedup_and_fraction_match(seed):
    rng = np.random.default_rng(seed)
    for e0, x, s in zip(rng.uniform(0.05, 1.0, 20), rng.uniform(0.0, 1.0, 20),
                        rng.uniform(0.5, 8.0, 20)):
        assert tpm.predicted_max_speedup(e0, x) == jpm.predicted_max_speedup(e0, x)
        assert tpm.fraction_of_predicted(s, e0, x) == jpm.fraction_of_predicted(s, e0, x)
    # the degenerate cases are defined, not singular
    assert tpm.fraction_of_predicted(1.0, 1.0, 0.91) == 1.0
    assert tpm.fraction_of_predicted(1.7, 0.4, 0.0) == 1.7


@pytest.mark.parametrize("seed", [0, 1])
def test_imbalance_summary_matches(seed):
    rng = np.random.default_rng(seed)
    ratios = 1.0 + rng.gamma(1.0, 0.5, 30)
    assert tpm.imbalance_summary(ratios) == jpm.imbalance_summary(ratios)
    flat = np.ones(5) - 1e-12  # rounding below 1 is clipped, not rejected
    assert tpm.imbalance_summary(flat) == jpm.imbalance_summary(flat)


@pytest.mark.parametrize(
    "fn,args",
    [
        ("fit_strong_scaling", ([1.0], [1.0])),
        ("fit_strong_scaling", ([1.0, 0.0], [1.0, 2.0])),
        ("predicted_max_speedup", (0.0, 0.9)),
        ("predicted_max_speedup", (0.5, -0.1)),
        ("fraction_of_predicted", (0.0, 0.5, 0.9)),
        ("imbalance_summary", ([],)),
        ("imbalance_summary", ([0.5, 1.2],)),
    ],
)
def test_invalid_inputs_raise_as_reference(fn, args):
    with pytest.raises(ValueError):
        getattr(jpm, fn)(*args)
    with pytest.raises(ValueError):
        getattr(tpm, fn)(*args)


def test_exported_from_core():
    from repro_torch import core

    assert set(tpm.__all__) <= set(core.__all__)
    assert core.predicted_max_speedup is tpm.predicted_max_speedup
