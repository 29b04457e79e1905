"""The port's synthetic LM data (``repro_torch.data.SyntheticLMData``)
against the reference's, over all ten ``SMOKE`` configs: tokens, labels
and the bfloat16 audio frames and patch embeddings bitwise equal for
several (seed, step); the reference's own determinism and label tests
(``tests/test_infra.py``) on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.data import SyntheticLMData as RefData
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData

SEED_STEPS = [(0, 0), (0, 7), (42, 3), (2**31 - 1, 1000)]


def bits(a) -> np.ndarray:
    """The raw bits of a reference or port array (bfloat16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batches_match_reference_bitwise(arch):
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    for seed, step in SEED_STEPS:
        want = RefData(ref_cfg, batch=3, seq_len=16, seed=seed).batch_at(step)
        got = SyntheticLMData(cfg, batch=3, seq_len=16, seed=seed, device="cpu").batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "cpu"
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=f"{k} seed {seed} step {step}")


def test_data_pipeline_deterministic_per_step():
    cfg = get_config("yi-9b", smoke=True)
    a = SyntheticLMData(cfg, batch=4, seq_len=8, seed=1, device="cpu")
    b = SyntheticLMData(cfg, batch=4, seq_len=8, seed=1, device="cpu")
    assert torch.equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])
    assert not torch.equal(a.batch_at(5)["tokens"], a.batch_at(6)["tokens"])


def test_data_pipeline_labels_shifted():
    cfg = get_config("yi-9b", smoke=True)
    batch = SyntheticLMData(cfg, batch=2, seq_len=8, seed=0, device="cpu").batch_at(0)
    tokens, labels = batch["tokens"].numpy(), batch["labels"].numpy()
    np.testing.assert_array_equal(labels[:, :-1], tokens[:, 1:])
    assert np.all(labels[:, -1] == -1)
    assert batch["tokens"].dtype == batch["labels"].dtype == torch.int32

