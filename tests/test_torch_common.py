"""The port's model building blocks and config registry against the
reference's (``repro_torch.models.common``, ``repro_torch.configs``,
``repro_torch.models.moe.init_moe``, ``repro_torch.convert.params_from``).

Exact: ``rope_freqs`` and ``sinusoidal_rows`` against the reference's
numpy ``rope_freqs`` (cast to float32, as its ``apply_rope`` casts it) and
``sinusoidal_positions``,
every ``CONFIG`` and ``SMOKE`` field by field (``param_dtype`` mapped from
the jnp dtype to the torch dtype), the reference's params carried across
bit for bit.  ``rmsnorm`` in float32 within rtol 1e-6 (``rsqrt`` may round
apart by an ulp); in bfloat16 within one bfloat16 ulp.  ``apply_rope``
within atol 1e-6 on unit-scale inputs.  The port's ``init_moe`` draws from
a torch generator, so it is held to the reference's tree (keys, shapes,
dtypes) and to the distribution: values inside ±2·scale, and the empirical
std of value/scale within 5% of the truncated normal's 0.8796.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import common as ref_common
from repro.models.moe import init_moe as ref_init_moe
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.convert import params_from, params_to_numpy
from repro_torch.models import common
from repro_torch.models.moe import init_moe

#: std of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.8796256610342398


def _bf16_to_f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    g = (0.1 * rng.standard_normal(48)).astype(np.float32)
    ref = common.rmsnorm  # port
    jdt = jnp.dtype(dtype)
    out_r = ref_common.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(g, jdt), eps=1e-6)
    tdt = getattr(torch, dtype)
    out_p = ref(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), eps=1e-6)
    assert out_p.dtype == tdt
    got, want = out_p.float().numpy(), _bf16_to_f32(out_r)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def test_rope_freqs_and_sinusoidal_positions_exact():
    for hd, theta in ((16, 10_000.0), (128, 500_000.0)):
        got = common.rope_freqs(hd, theta)
        assert got.dtype == torch.float32 and got is common.rope_freqs(hd, theta)
        np.testing.assert_array_equal(got.numpy(), ref_common.rope_freqs(hd, theta).astype(np.float32))
    np.testing.assert_array_equal(common.sinusoidal_rows(torch.arange(37), 64).numpy(),
                                  ref_common.sinusoidal_positions(37, 64))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1)) + np.array([[0], [40]], np.int32)
    out_r = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out_p = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), atol=1e-6)


def test_constrain_batch_is_identity():
    x = torch.ones(4, 3)
    assert common.constrain_batch(x) is x


def test_arch_registry_matches_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert set(all_configs()) == set(ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_equals_reference_field_by_field(arch, smoke):
    ref, port = ref_get_config(arch, smoke), get_config(arch, smoke)
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "param_dtype":
            assert got == getattr(torch, jnp.dtype(want).name), (f.name, got, want)
        else:
            assert got == want, (f.name, got, want)
    assert port.hd == ref.hd and port.vocab_padded == ref.vocab_padded


def _moe_cfgs():
    toy = common.ModelConfig(
        name="serve-toy", kind="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab=64, n_experts=16, top_k=2, param_dtype=torch.float32,
    )
    return {"toy-f32": toy,
            "scout-smoke-bf16": get_config("llama4-scout-17b-a16e", smoke=True),
            "mixtral-smoke-bf16": get_config("mixtral-8x7b", smoke=True)}


@pytest.mark.parametrize("name", list(_moe_cfgs()))
def test_init_moe_gives_the_reference_tree_and_distribution(name):
    cfg = _moe_cfgs()[name]
    ref_cfg = ref_common.ModelConfig(**{
        f.name: (jnp.dtype(str(cfg.param_dtype).removeprefix("torch.")) if f.name == "param_dtype"
                 else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)
    })
    ref_params, ref_specs = ref_init_moe(jax.random.PRNGKey(0), ref_cfg)
    params, specs = init_moe(0, cfg, device="cpu")
    assert specs == ref_specs
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(ref_params)[0])
    flat_ref = {jax.tree_util.keystr(k): v for k, v in ref_leaves.items()}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    flat = dict(walk(params))
    assert flat.keys() == flat_ref.keys()
    normed = []
    for key, t in flat.items():
        r = flat_ref[key]
        assert tuple(t.shape) == tuple(r.shape), key
        assert t.dtype == getattr(torch, jnp.dtype(r.dtype).name), key
        v = t.float().numpy()
        if key.endswith("['b_up']") or key.endswith("['b_down']"):
            assert not v.any()
            continue
        scale = 1.0 / np.sqrt(t.shape[0])
        bound = float(torch.tensor(2.0 * scale).to(t.dtype).float())
        assert np.abs(v).max() <= bound, key
        normed.append(v.ravel() / scale)
    std = np.concatenate(normed).std()
    assert abs(std / TRUNC_STD - 1.0) < 0.05, std


def test_init_moe_is_seeded():
    cfg = _moe_cfgs()["toy-f32"]
    a, _ = init_moe(3, cfg, device="cpu")
    b, _ = init_moe(torch.Generator().manual_seed(3), cfg)
    c, _ = init_moe(4, cfg, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w_up"], c["w_up"])


def test_params_from_carries_bf16_bit_for_bit():
    """A reference bf16 tree crosses through its uint16 bits and back."""
    cfg = ref_get_config("llama4-scout-17b-a16e", smoke=True)
    ref_params, _ = ref_init_moe(jax.random.PRNGKey(2), cfg)
    host = jax.tree.map(np.asarray, ref_params)
    params = params_from(host, "cpu")
    assert params["w_gate"].dtype == torch.bfloat16
    assert params["shared"]["w_up"].dtype == torch.bfloat16
    assert params["router"].dtype == torch.float32
    back = params_to_numpy(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(host)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf, np.float32))
        t = params
        for k in path:
            t = t[k.key]
        bits = np.asarray(leaf).view(np.uint16) if leaf.dtype.name == "bfloat16" else None
        if bits is not None:
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)


def test_default_device_is_cuda():
    """Entry points default to ``device="cuda"``, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        init_moe(0, _moe_cfgs()["toy-f32"])


def test_sinusoidal_rows_match_the_table():
    """Rows computed on the positions' device equal ``sinusoidal_positions``
    (the reference's numpy table) to float32 rounding."""
    table = ref_common.sinusoidal_positions(50, 64)
    rows = common.sinusoidal_rows(torch.tensor([0, 7, 49, 3]), 64)
    np.testing.assert_allclose(rows.numpy(), table[[0, 7, 49, 3]], rtol=0, atol=1e-7)
    one = common.sinusoidal_rows(torch.tensor(12, dtype=torch.int32), 64)
    assert tuple(one.shape) == (64,) and one.dtype == torch.float32
    np.testing.assert_allclose(one.numpy(), table[12], rtol=0, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sigmoid", "silu", "gelu_tanh", "softplus"])
def test_activations_match_jax_nn(name, dtype):
    """The activations as ``jax.nn`` composes them: in bfloat16 equal to the
    reference's bit for bit on all but a few elements (one rounding per
    operation, constants rounded to the dtype first), in float32 within 4
    ulps or 1e-6 (the elementary functions of XLA and torch differ by ulps,
    which near tanh's saturation leave small values relatively far
    apart)."""
    ref = {"sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu, "gelu_tanh": jax.nn.gelu,
           "softplus": jax.nn.softplus}[name]
    x = (3 * np.random.default_rng(7).standard_normal(20_000)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(ref)(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = getattr(common, name)(torch.from_numpy(x).to(tdt)).float().numpy()
    if dtype == "bfloat16":
        assert np.mean(got != want) < 1e-3, np.mean(got != want)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * 2.0**-23, atol=1e-6)


def test_n_params_counts_the_meta_tree():
    for arch in ("qwen3-14b", "recurrentgemma-9b", "whisper-medium"):
        assert get_config(arch).n_params == ref_get_config(arch).n_params
    assert get_config("qwen3-14b").n_params == 14_769_617_920
