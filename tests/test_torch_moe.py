"""The port's MoE block (``repro_torch.models.moe``) against the reference's.

Params come from the reference's ``init_moe(jax.random.PRNGKey(s), cfg)``,
carried over through ``repro_torch.convert.params_from``; inputs come from
numpy seeds and go through both.  Tolerances are the reference's own
(``tests/test_moe.py``): routing stats and the dropped fraction exact,
outputs within atol 1e-5 (with bf16 params, whose outputs reach ~70,
within 1e-5·max|out|), ``aux_loss`` within rtol 1e-6.  A routing
difference reports the router's probability margin between the
k-th and (k+1)-th choice of the tokens that differ (a near tie XLA and
torch may round apart); it does not loosen the exact check.

The port's two dispatches are held to each other at the reference's own
einsum-vs-sort bound, rtol 1e-4 / atol 2e-4.  The port is held to
``jax.grad`` of the reference at rtol 1e-4 plus an atol of
``GRAD_ATOL_REL``·max|g| per leaf: the gradients reach max|g| ~
1e4-4.4e4, where a float32 ulp is ~1e-3, and XLA and torch sum in
different orders, so atol 2e-4 is under an ulp there.
``test_float32_gradient_gap_within_tolerance`` measures the float32 rounding
of both packages' gradients against the port's float64 gradients: at most
7.46e-7 of the leaf's max|g| (the reference's ``w_up``; the port's at most
5.63e-7), so ``GRAD_ATOL_REL`` is twice that, 1.5e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.common import ModelConfig as RefConfig
from repro.models.moe import (
    apply_expert_permutation as ref_permute,
    expert_costs as ref_expert_costs,
    init_mlp as ref_init_mlp,
    init_moe as ref_init_moe,
    mlp as ref_mlp,
    moe as ref_moe,
)
from repro_torch.configs import get_config
from repro_torch.convert import params_from, params_to_numpy
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import apply_expert_permutation, expert_costs, mlp, moe

BASE = dict(
    name="t", kind="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=48, vocab=64, n_experts=4, top_k=2, capacity_factor=1.5,
)
STATS_EXACT = ("tokens_per_expert", "slots_filled", "dropped_fraction")
#: gradient atol relative to each leaf's max|g|: twice the largest float32
#: vs float64 gap measured by ``test_float32_gradient_gap_within_tolerance``
GRAD_ATOL_REL = 1.5e-6


def make(cfg_kwargs=None, seed=0, n_tokens=64, f32=True):
    """(reference cfg, port cfg, reference params, port params, x numpy)."""
    kw = dict(BASE, **(cfg_kwargs or {}))
    ref_cfg, cfg = RefConfig(**kw), ModelConfig(**kw)
    rp, _ = ref_init_moe(jax.random.PRNGKey(seed), ref_cfg)
    if f32:
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, n_tokens // 2, kw["d_model"])
    ).astype(np.float32)
    return ref_cfg, cfg, rp, params_from(jax.tree.map(np.asarray, rp), "cpu"), x


def routing_margin(x, router, k):
    """Smallest gap between the k-th and (k+1)-th router probability over
    the tokens (float64): how close the routing came to a tie."""
    logits = np.asarray(x, np.float64) @ np.asarray(router, np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    s = -np.sort(-probs, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min()) if k < s.shape[-1] else float("inf")


def run_both(ref_cfg, cfg, rp, pp, x):
    out_r, st_r = ref_moe(rp, ref_cfg, jnp.asarray(x))
    out_p, st_p = moe(pp, cfg, torch.from_numpy(x))
    return (np.asarray(out_r), {k: np.asarray(v) for k, v in st_r.items()},
            out_p.numpy(), {k: v.numpy() for k, v in st_p.items()})


def assert_matches(ref_cfg, cfg, rp, pp, x, rel=False):
    """Stats exact, aux loss within rtol 1e-6, outputs within atol 1e-5 (or,
    with ``rel``, within 1e-5·max|out| of the reference)."""
    out_r, st_r, out_p, st_p = run_both(ref_cfg, cfg, rp, pp, x)
    atol = 1e-5 * float(np.abs(out_r).max()) if rel else 1e-5
    for key in STATS_EXACT:
        if not np.array_equal(st_p[key], st_r[key]):
            margin = routing_margin(x, rp["router"], cfg.top_k)
            raise AssertionError(
                f"{key}: port {st_p[key]} vs reference {st_r[key]}; "
                f"smallest router probability margin {margin:.3g}"
            )
    np.testing.assert_allclose(out_p, out_r, atol=atol)
    np.testing.assert_allclose(st_p["aux_loss"], st_r["aux_loss"], rtol=1e-6)
    return out_p, st_p


@pytest.mark.parametrize("impl", ["sort", "einsum"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 2.0])
def test_moe_matches_reference(impl, top_k, capacity_factor):
    ref_cfg, cfg, rp, pp, x = make({"top_k": top_k, "capacity_factor": capacity_factor,
                                    "moe_impl": impl})
    assert_matches(ref_cfg, cfg, rp, pp, x)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 2.0])
def test_sort_matches_einsum(top_k, capacity_factor):
    """Both of the port's dispatch implementations are the same function,
    capacity drops included."""
    _, cfg, _, pp, x = make({"top_k": top_k, "capacity_factor": capacity_factor})
    xt = torch.from_numpy(x)
    out_e, stats_e = moe(pp, cfg.scaled(moe_impl="einsum"), xt)
    out_s, stats_s = moe(pp, cfg.scaled(moe_impl="sort"), xt)
    np.testing.assert_allclose(out_e.numpy(), out_s.numpy(), atol=1e-5)
    for key in ("tokens_per_expert", "slots_filled"):
        np.testing.assert_array_equal(stats_e[key].numpy(), stats_s[key].numpy())


def _port_grads(cfg, pp, x, impl, dtype=torch.float32):
    leaves = {k: v.to(dtype).clone().requires_grad_(True) for k, v in pp.items()}
    out, stats = moe(leaves, cfg.scaled(moe_impl=impl), torch.from_numpy(x).to(dtype))
    ((out ** 2).sum() + stats["aux_loss"]).backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}


def _ref_grads(ref_cfg, rp, x):
    def f(px):
        out, stats = ref_moe(px, ref_cfg, jnp.asarray(x))
        return (out ** 2).sum() + stats["aux_loss"]

    return {k: np.asarray(v) for k, v in jax.grad(f)(rp).items()}


def test_gradients_match_between_impls_and_reference():
    """torch autograd through both impls agrees with itself at the
    reference's tolerance, and with ``jax.grad`` of the reference at rtol
    1e-4 plus the measured float32 rounding (``GRAD_ATOL_REL``·max|g| per
    leaf)."""
    ref_cfg, cfg, rp, pp, x = make()
    g_e, g_s = _port_grads(cfg, pp, x, "einsum"), _port_grads(cfg, pp, x, "sort")
    g_ref = _ref_grads(ref_cfg, rp, x)
    for k in pp:
        np.testing.assert_allclose(g_e[k], g_s[k], rtol=1e-4, atol=2e-4, err_msg=k)
        atol = GRAD_ATOL_REL * float(np.abs(g_ref[k]).max())
        np.testing.assert_allclose(g_s[k], g_ref[k], rtol=1e-4, atol=atol, err_msg=k)


def test_float32_gradient_gap_within_tolerance():
    """The measurement behind ``GRAD_ATOL_REL``: the port's gradients in
    float64 (params and ``x`` in float64, on the CPU) against the float32
    gradients of the port (both dispatches) and of the reference, each gap
    relative to the leaf's max|g|.  Measured: at most 7.46e-7, and
    ``GRAD_ATOL_REL`` is twice it."""
    ref_cfg, cfg, rp, pp, x = make()
    g64 = _port_grads(cfg, pp, x, "sort", dtype=torch.float64)
    g32 = [_port_grads(cfg, pp, x, "sort"), _port_grads(cfg, pp, x, "einsum"),
           _ref_grads(ref_cfg, rp, x)]
    worst = max(float(np.abs(g[k] - g64[k]).max() / np.abs(g64[k]).max())
                for g in g32 for k in pp)
    assert 1e-8 < worst and 2 * worst <= GRAD_ATOL_REL, worst


def test_capacity_drops_reported():
    ref_cfg, cfg, rp, pp, x = make({"capacity_factor": 0.25})
    _, stats = assert_matches(ref_cfg, cfg, rp, pp, x)
    assert float(stats["dropped_fraction"]) > 0.0
    assert float(stats["slots_filled"].sum()) < float(stats["tokens_per_expert"].sum())


def test_stats_counts_consistent():
    _, cfg, _, pp, x = make()
    _, stats = moe(pp, cfg, torch.from_numpy(x))
    assert float(stats["tokens_per_expert"].sum()) == x.shape[0] * x.shape[1] * cfg.top_k


def test_expert_costs_strategies():
    ref_cfg, cfg, rp, pp, x = make()
    _, st_r = ref_moe(rp, ref_cfg, jnp.asarray(x))
    _, st_p = moe(pp, cfg, torch.from_numpy(x))
    for strategy in ("heuristic", "work_counter"):
        got = expert_costs(st_p, strategy)
        assert got.dtype == np.float64 and got.shape == (cfg.n_experts,)
        np.testing.assert_array_equal(got, ref_expert_costs(st_r, strategy))
    assert np.all(expert_costs(st_p, "work_counter") <= expert_costs(st_p, "heuristic"))


@pytest.mark.parametrize("perm", [[2, 0, 3, 1], [3, 2, 1, 0], [0, 1, 2, 3]])
def test_apply_expert_permutation_bitwise_and_preserves_function(perm):
    """The permuted params are the reference's bit for bit, and the served
    function does not change."""
    _, cfg, rp, pp, x = make()
    perm = np.asarray(perm)
    permuted = apply_expert_permutation(pp, perm)
    ref_permuted = ref_permute(rp, perm)
    got = params_to_numpy(permuted)
    for k in ref_permuted:
        np.testing.assert_array_equal(got[k], np.asarray(ref_permuted[k]))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(moe(permuted, cfg, xt)[0].numpy(), moe(pp, cfg, xt)[0].numpy(),
                               atol=1e-5)


def test_top_k_tie_keeps_the_lower_index():
    """Two equal router columns: ``jax.lax.top_k`` puts the lower index
    first, and so must the port (the order sets capacity positions)."""
    for top_k in (1, 2):
        ref_cfg, cfg, rp, pp, x = make({"top_k": top_k, "capacity_factor": 1.0})
        router = np.asarray(rp["router"]).copy()
        router[:, 1] = router[:, 0]
        rp = dict(rp, router=jnp.asarray(router))
        pp = dict(pp, router=torch.from_numpy(router))
        _, stats = assert_matches(ref_cfg, cfg, rp, pp, x)
        if top_k == 1:
            assert float(stats["tokens_per_expert"][1]) == 0.0  # 0 always wins the tie
            assert float(stats["tokens_per_expert"][0]) > 0.0


def test_shared_expert_matches_reference():
    """Scout's SMOKE config (top-1 plus the shared SwiGLU expert), f32 params."""
    ref_cfg = ref_get_config("llama4-scout-17b-a16e", smoke=True)
    cfg = get_config("llama4-scout-17b-a16e", smoke=True)
    assert cfg.shared_expert and cfg.top_k == 1
    rp, _ = ref_init_moe(jax.random.PRNGKey(3), ref_cfg)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    pp = params_from(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    assert_matches(ref_cfg, cfg, rp, pp, x)


def test_gelu_mlp_matches_reference():
    """Whisper's GeLU MLP (``jax.nn.gelu`` is the tanh approximation)."""
    ref_cfg = ref_get_config("whisper-medium", smoke=True)
    cfg = get_config("whisper-medium", smoke=True)
    rp, _ = ref_init_mlp(jax.random.PRNGKey(5), ref_cfg)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    rng = np.random.default_rng(6)
    rp = dict(rp, b_up=jnp.asarray(rng.standard_normal(cfg.d_ff), jnp.float32),
              b_down=jnp.asarray(rng.standard_normal(cfg.d_model), jnp.float32))
    pp = params_from(jax.tree.map(np.asarray, rp), "cpu")
    x = rng.standard_normal((8, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(mlp(pp, cfg, torch.from_numpy(x)).numpy(),
                               np.asarray(ref_mlp(rp, ref_cfg, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mixtral-8x7b"])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_bf16_params_match_reference(arch, impl):
    """bf16 params (a SMOKE config at its default ``param_dtype``) carried
    across as bf16: float32 traffic promotes every product to float32 in
    both packages, so outputs agree to float32 rounding.  These outputs
    reach ~70 (the expert stacks are drawn at scale 1/sqrt(E), as the
    reference's ``init_dense`` does), where a float32 ulp is 7.6e-6, so the
    bound is taken relative to the output: 1e-5·max|out|, as the card
    check of the full-width block."""
    ref_cfg = ref_get_config(arch, smoke=True).scaled(moe_impl=impl)
    cfg = get_config(arch, smoke=True).scaled(moe_impl=impl)
    rp, _ = ref_init_moe(jax.random.PRNGKey(1), ref_cfg)
    assert rp["w_gate"].dtype == jnp.bfloat16
    pp = params_from(jax.tree.map(np.asarray, rp), "cpu")
    assert pp["w_gate"].dtype == torch.bfloat16 and pp["router"].dtype == torch.float32
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    out, _ = assert_matches(ref_cfg, cfg, rp, pp, x, rel=True)
    assert out.dtype == np.float32
