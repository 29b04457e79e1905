"""The port's SSD and RG-LRU blocks (``repro_torch.models.ssm``,
``repro_torch.models.rglru``) against the reference's.

Params come from the reference's ``init_ssd`` / ``init_rglru_block`` on
``PRNGKey(s)`` (the SSD's zero-initialised ``dt_bias`` and ``norm``
redrawn from numpy so that they take part), inputs from numpy seeds; the
reference runs under ``jax.jit``.  Every check runs with
float32 params and inputs, within 2e-5·max|ref|, and with bfloat16 ones at
the reference's bfloat16 bound, rtol 0.1 / atol 0.15.  The SSD runs four
chunks (``ssm_chunk = 4``, S = 16); the RG-LRU runs S = 13, not a power of
two, so its scan takes both of ``jax.lax.associative_scan``'s odd and even
branches.  The returned states match, and decoding from a fresh state
reproduces the forward's last position (``tests/test_arch_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from
from repro_torch.models import rglru, ssm
from test_torch_attention import DTYPES, assert_close, f32, inputs


def _configs(arch: str, dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    return (ref_get_config(arch, smoke=True).scaled(param_dtype=jdt, **kw),
            get_config(arch, smoke=True).scaled(param_dtype=tdt, **kw))


def _params(rp, dtype: str, redraw=(), seed: int = 0):
    jdt = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    rp = {k: (jnp.asarray(0.3 * rng.standard_normal(v.shape), v.dtype) if k in redraw
              else (v.astype(jdt) if v.dtype == jnp.bfloat16 else v))
          for k, v in rp.items()}
    return rp, params_from(jax.tree.map(np.asarray, rp), "cpu")


def ssd_case(dtype: str, seed: int = 0):
    ref_cfg, cfg = _configs("mamba2-780m", dtype, ssm_chunk=4)
    rp, _ = ref_ssm.init_ssd(jax.random.PRNGKey(seed), ref_cfg)
    return (ref_cfg, cfg) + _params(rp, dtype, redraw=("dt_bias", "norm"), seed=seed + 50)


def rglru_case(dtype: str, seed: int = 0):
    ref_cfg, cfg = _configs("recurrentgemma-9b", dtype)
    rp, _ = ref_rglru.init_rglru_block(jax.random.PRNGKey(seed), ref_cfg)
    return (ref_cfg, cfg) + _params(rp, dtype)


def assert_state(got, ref, dtype: str, label: str) -> None:
    for field in got._fields:
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == torch.float32, (label, field, g.dtype)
        assert_close(g, r, dtype, err_msg=f"{label} {field}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_forward_matches_reference(dtype):
    ref_cfg, cfg, rp, pp = ssd_case(dtype)
    ur, up = inputs((2, 16, cfg.d_model), dtype, 1)
    ref = jax.jit(lambda p, u: ref_ssm.ssd_forward(p, ref_cfg, u))(rp, ur)
    got = ssm.ssd_forward(pp, cfg, up)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, ref, dtype)


def test_ssd_forward_rejects_ragged_chunks():
    _, cfg, _, pp = ssd_case("float32")
    with pytest.raises(ValueError, match="divisible"):
        ssm.ssd_forward(pp, cfg, torch.zeros(1, 6, cfg.d_model))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_steps_and_states_match_reference(dtype):
    ref_cfg, cfg, rp, pp = ssd_case(dtype, seed=1)
    rs, ps = ref_ssm.init_ssd_state(ref_cfg, 2), ssm.init_ssd_state(cfg, 2, device="cpu")
    step_r = jax.jit(lambda p, u, s: ref_ssm.ssd_decode_step(p, ref_cfg, u, s))
    for step in range(6):
        ur, up = inputs((2, 1, cfg.d_model), dtype, 20 + step)
        out_r, rs = step_r(rp, ur, rs)
        out_p, ps = ssm.ssd_decode_step(pp, cfg, up, ps)
        assert_close(out_p, out_r, dtype, err_msg=f"step {step}")
        assert_state(ps, rs, dtype, f"step {step}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_forward_matches_reference(dtype):
    ref_cfg, cfg, rp, pp = rglru_case(dtype)
    ur, up = inputs((2, 13, cfg.d_model), dtype, 2)
    ref = jax.jit(lambda p, u: ref_rglru.rglru_forward(p, ref_cfg, u))(rp, ur)
    got = rglru.rglru_forward(pp, cfg, up)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_steps_and_states_match_reference(dtype):
    ref_cfg, cfg, rp, pp = rglru_case(dtype, seed=3)
    rs, ps = ref_rglru.init_rglru_state(ref_cfg, 2), rglru.init_rglru_state(cfg, 2, device="cpu")
    step_r = jax.jit(lambda p, u, s: ref_rglru.rglru_decode_step(p, ref_cfg, u, s))
    for step in range(6):
        ur, up = inputs((2, 1, cfg.d_model), dtype, 30 + step)
        out_r, rs = step_r(rp, ur, rs)
        out_p, ps = rglru.rglru_decode_step(pp, cfg, up, ps)
        assert_close(out_p, out_r, dtype, err_msg=f"step {step}")
        assert_state(ps, rs, dtype, f"step {step}")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 31])
def test_associative_scan_follows_the_reference_association(n):
    """The linear-recurrence combine over lengths that take every branch of
    the recursion: float32 results equal to jax's within 4 ulps of the
    largest value (the two may round ``a2*b1 + b2`` with or without a fused
    multiply-add), and equal to a sequential loop within 1e-5."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (3, n, 5)).astype(np.float32)
    b = rng.standard_normal((3, n, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    ra, rb = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    pa, pb = rglru.associative_scan(combine, (torch.from_numpy(a), torch.from_numpy(b)), dim=1)
    for got, ref in ((pa, ra), (pb, rb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=4 * np.spacing(np.abs(ref).max(), dtype=np.float32))
    h = np.zeros((3, 5), np.float32)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(pb.numpy()[:, -1], h, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", ["ssd", "rglru"])
def test_decode_from_fresh_state_matches_forward_tail(block, dtype):
    """Decoding S tokens one at a time from a fresh state gives the full
    forward's last position, in the port and in the reference alike."""
    if block == "ssd":
        ref_cfg, cfg, rp, pp = ssd_case(dtype, seed=4)
        fwd, step, init = ssm.ssd_forward, ssm.ssd_decode_step, ssm.init_ssd_state
        ref_fwd = ref_ssm.ssd_forward
    else:
        ref_cfg, cfg, rp, pp = rglru_case(dtype, seed=4)
        fwd, step, init = rglru.rglru_forward, rglru.rglru_decode_step, rglru.init_rglru_state
        ref_fwd = ref_rglru.rglru_forward
    ur, up = inputs((1, 8, cfg.d_model), dtype, 40)
    full = fwd(pp, cfg, up)
    st = init(cfg, 1, device="cpu")
    for i in range(8):
        out, st = step(pp, cfg, up[:, i : i + 1], st)
    assert_close(out[0, 0], full[0, -1], dtype)
    ref_full = jax.jit(lambda p, u: ref_fwd(p, ref_cfg, u))(rp, ur)
    assert_close(full[0, -1], np.asarray(f32(ref_full))[0, -1], dtype)


@pytest.mark.parametrize("block", ["ssd", "rglru"])
def test_states_on_meta_allocate_nothing(block):
    _, cfg = _configs("mamba2-780m" if block == "ssd" else "recurrentgemma-9b", "bfloat16")
    init = ssm.init_ssd_state if block == "ssd" else rglru.init_rglru_state
    st = init(cfg, 128, device="meta")
    assert all(t.is_meta and t.dtype == torch.float32 for t in st)
