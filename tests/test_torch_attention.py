"""The port's attention (``repro_torch.models.attention``) against the
reference's.

Params come from the reference's ``init_attention(PRNGKey(s), cfg)``, with
its zero-initialised leaves (QKV biases, qk-norm scales) redrawn from numpy
so that they take part; inputs come from numpy seeds.  The reference runs
under ``jax.jit``.  Every check runs twice: with float32
params and inputs, within 2e-5·max|ref| (the flash checks at the
reference's own atol 2e-5, ``tests/test_infra.py``), and with bfloat16
params and inputs at the reference's bfloat16 bound, rtol 0.1 / atol 0.15
(``tests/test_arch_smoke.py``).

The reference's own flash test sets ``FLASH_Q_BLOCK``/``FLASH_KV_BLOCK``
after ``_flash_sdpa``'s defaults were bound, so it runs one 64 x 64 block;
these tests pass the blocks explicitly (16/16 and 8/16) and so compare the
multi-block and the window/chunk reach-restricted paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models.common import ModelConfig as RefConfig
from repro_torch.convert import params_from
from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig

BASE = dict(name="t", kind="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64)
VARIANTS = {
    "gqa": {},
    "qkv_bias": {"qkv_bias": True},
    "qk_norm": {"qk_norm": True},
    "window": {"sliding_window": 8},
    "chunk": {"attn_chunk": 8},
    "mqa": {"n_kv_heads": 1},
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, ref, dtype: str, err_msg: str = "") -> None:
    """float32: max|Δ| ≤ 2e-5·max|ref|; bfloat16: rtol 0.1, atol 0.15."""
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    if dtype == "float32":
        bound = 2e-5 * max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got, ref, rtol=0, atol=bound, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, ref, rtol=0.1, atol=0.15, err_msg=err_msg)


def make(variant: str, dtype: str, seed: int = 0, cross: bool = False):
    """(reference cfg, port cfg, reference params, port params)."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(BASE, **VARIANTS[variant])
    ref_cfg, cfg = RefConfig(**kw, param_dtype=jdt), ModelConfig(**kw, param_dtype=tdt)
    rp, _ = ref_attn.init_attention(jax.random.PRNGKey(seed), ref_cfg, cross=cross)
    rng = np.random.default_rng(seed + 100)
    rp = {k: (jnp.asarray(0.3 * rng.standard_normal(v.shape), jdt)
              if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v.astype(jdt))
          for k, v in rp.items()}
    return ref_cfg, cfg, rp, params_from(jax.tree.map(np.asarray, rp), "cpu")


def inputs(shape, dtype: str, seed: int):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_attention_matches_reference(variant, dtype):
    ref_cfg, cfg, rp, pp = make(variant, dtype)
    xr, xp = inputs((2, 24, 32), dtype, 1)
    pos = np.tile(np.arange(24), (2, 1))
    ref = jax.jit(lambda p, x: ref_attn.attention(p, ref_cfg, x, jnp.asarray(pos)))(rp, xr)
    got = attn.attention(pp, cfg, xp, torch.from_numpy(pos))
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_reference(dtype):
    ref_cfg, cfg, rp, pp = make("gqa", dtype, seed=2, cross=True)
    assert "bq" not in pp
    xr, xp = inputs((2, 12, 32), dtype, 3)
    er, ep = inputs((2, 20, 32), dtype, 4)
    pos = np.tile(np.arange(12), (2, 1))
    ref = jax.jit(lambda p, x, e: ref_attn.attention(p, ref_cfg, x, jnp.asarray(pos), x_kv=e,
                                                     use_rope=False))(rp, xr, er)
    got = attn.attention(pp, cfg, xp, torch.from_numpy(pos), x_kv=ep, use_rope=False)
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", [(16, 16), (8, 16)], ids=["q16kv16", "q8kv16"])
@pytest.mark.parametrize("window,chunk", [(None, None), (8, None), (None, 8)],
                         ids=["causal", "window8", "chunk8"])
def test_flash_sdpa_matches_reference_and_naive(window, chunk, blocks, dtype):
    """Both packages' ``_flash_sdpa`` on the same q/k/v with the same
    explicit blocks (S = 64: four or eight query blocks, four KV blocks, of
    which a window or chunk of 8 reaches two), and the port's flash against
    its own ``_sdpa`` under the equivalent mask."""
    q_block, kv_block = blocks
    qr, qp = inputs((2, 64, 4, 8), dtype, 5)
    kr, kp = inputs((2, 64, 2, 8), dtype, 6)
    vr, vp = inputs((2, 64, 2, 8), dtype, 7)
    kw = dict(causal=True, window=window, chunk=chunk, q_block=q_block, kv_block=kv_block)
    ref = jax.jit(lambda q, k, v: ref_attn._flash_sdpa(q, k, v, **kw))(qr, kr, vr)
    got = attn._flash_sdpa(qp, kp, vp, **kw)
    naive = attn._sdpa(qp, kp, vp, attn._mask(64, 64, 0, True, window, chunk))
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(ref), atol=2e-5)
        np.testing.assert_allclose(f32(got), f32(naive), atol=2e-5)
    else:
        assert_close(got, ref, dtype)
        assert_close(got, naive, dtype)


def test_flash_sdpa_rejects_blocks_that_do_not_tile():
    q = torch.zeros(1, 24, 2, 4)
    k = torch.zeros(1, 24, 1, 4)
    with pytest.raises(ValueError, match="tile"):
        attn._flash_sdpa(q, k, k, causal=True, window=None, chunk=None, q_block=16, kv_block=8)


def test_attention_takes_the_flash_path_when_forced():
    """``force_flash=True`` routes through ``_flash_sdpa`` (default blocks,
    one block at S = 24) and gives ``_sdpa``'s result."""
    _, cfg, _, pp = make("window", "float32")
    _, xp = inputs((2, 24, 32), "float32", 8)
    pos = torch.arange(24).expand(2, 24)
    np.testing.assert_allclose(f32(attn.attention(pp, cfg, xp, pos, force_flash=True)),
                               f32(attn.attention(pp, cfg, xp, pos, force_flash=False)),
                               atol=2e-5)


def _kv_numpy(cache):
    return {"k": f32(cache.k), "v": f32(cache.v), "length": np.asarray(cache.length)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("filled", [False, True], ids=["empty", "filled"])
@pytest.mark.parametrize("variant", ["gqa", "window", "chunk"])
def test_decode_attention_matches_reference(variant, filled, dtype):
    """20 decode steps; the cache holds 16 tokens (a ring of 8 under the
    window or chunk), so the writes wrap.  From an empty cache most slots
    are invalid at first (the uniform ``NEG_INF`` rows); a filled cache
    starts at position 16, whose first write lands in slot 0.  The output
    and the cache after every step match the reference's."""
    ref_cfg, cfg, rp, pp = make(variant, dtype, seed=9)
    rc = ref_attn.init_kv_cache(ref_cfg, 2, 16, filled=filled)
    pc = attn.init_kv_cache(cfg, 2, 16, filled=filled, device="cpu")
    step_r = jax.jit(lambda p, x, c: ref_attn.decode_attention(p, ref_cfg, x, c))
    assert pc.capacity == rc.capacity == (16 if variant == "gqa" else 8)
    assert pc.length.dtype == torch.int32 and pc.length.ndim == 0
    for step in range(20):
        xr, xp = inputs((2, 1, 32), dtype, 100 + step)
        out_r, rc = step_r(rp, xr, rc)
        out_p, pc = attn.decode_attention(pp, cfg, xp, pc)
        assert_close(out_p, out_r, dtype, err_msg=f"step {step}")
        got, want = _kv_numpy(pc), _kv_numpy(rc)
        assert int(got["length"]) == int(want["length"]) == (16 if filled else 0) + step + 1
        for key in ("k", "v"):
            assert_close(got[key], want[key], dtype, err_msg=f"{key} step {step}")


def test_decode_attention_writes_the_cache_in_place():
    _, cfg, _, pp = make("window", "float32", seed=10)
    cache = attn.init_kv_cache(cfg, 2, 16, filled=True, device="cpu")
    k_before = cache.k
    _, new = attn.decode_attention(pp, cfg, inputs((2, 1, 32), "float32", 11)[1], cache)
    assert new.k is k_before and new.v is cache.v
    assert float(k_before[:, 0].abs().sum()) > 0  # position 16 of a ring of 8: slot 0
    assert float(k_before[:, 1:].abs().sum()) == 0
    assert int(new.length) == 17 and int(cache.length) == 16


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_attention_matches_reference(dtype):
    ref_cfg, cfg, rp, pp = make("gqa", dtype, seed=12, cross=True)
    kr, kp = inputs((2, 20, 2, 8), "bfloat16", 13)
    vr, vp = inputs((2, 20, 2, 8), "bfloat16", 14)
    xr, xp = inputs((2, 1, 32), dtype, 15)
    rc = ref_attn.init_kv_cache(ref_cfg, 2, 16)
    pc = attn.init_kv_cache(cfg, 2, 16, device="cpu")
    out_r, _ = jax.jit(lambda p, x, c, k, v: ref_attn.decode_attention(
        p, ref_cfg, x, c, cross_kv=(k, v)))(rp, xr, rc, kr, vr)
    out_p, same = attn.decode_attention(pp, cfg, xp, pc, cross_kv=(kp, vp))
    assert same is pc
    assert_close(out_p, out_r, dtype)


def test_init_kv_cache_on_meta_allocates_nothing():
    _, cfg, _, _ = make("chunk", "bfloat16")
    cache = attn.init_kv_cache(cfg, 128, 32_768, device="meta")
    assert cache.k.is_meta and cache.v.is_meta and cache.length.is_meta
    assert tuple(cache.k.shape) == (128, 8, 2, 8)
