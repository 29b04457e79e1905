"""The port's optimizer (``repro_torch.train.optimizer``) against the
reference's.

Params, gradients and residuals come from numpy seeds and go through both;
the reference runs op by op (each ``jnp`` operation compiled alone, one
rounding each).  The port updates in place, so it is handed copies.
Tolerances: ``grad_norm`` at rtol 1e-6 (the two packages sum each leaf's
squares in other orders); ``adamw_update``'s params, ``m`` and ``v`` within
2 float32 ulps of the reference's (bfloat16 params: within one bfloat16
rounding of that) when both clip by the same scale, that is on gradients
whose squares sum exactly in any order (measured: bitwise); on normal
gradients, within 2 ulps plus what the norm's rtol carries into a clipped
gradient (1e-6·max|leaf|, 2e-6 for ``v``);
``quantize_int8``'s ``q`` and ``scale`` bitwise; ``compress_decompress``'s
gradients bitwise and its residual within 1 ulp.  Both gradient dtypes
the train step hands the optimizer are covered: the params' dtype
(``grad_accum == 1``) and float32 (``grad_accum > 1``).  The last tests
mirror the reference's own (``tests/test_infra.py``): convergence on a
quadratic, unbiased error feedback, the int8 round-trip bound, compressed
convergence and clipping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch._device import map_tensors
from repro_torch.convert import params_from, params_to_numpy
from repro_torch.train import optimizer as opt

#: leaf shapes, keys deliberately not in sorted order (the reference's
#: flatten order sorts them, and it fixes the global norm's sum order)
SHAPES = {"w": (64, 32), "b": (32,), "nested": {"z": (8, 8, 4), "a": (5,)}, "emb": (300, 16)}
#: (params dtype, grads dtype): the train step's two cases and float32
DTYPE_CASES = {
    "f32-params": ("float32", "float32"),
    "bf16-params-bf16-grads": ("bfloat16", "bfloat16"),
    "bf16-params-f32-grads": ("bfloat16", "float32"),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: per-step gradient scales: the first steps' global norm is above
#: max_grad_norm (clipping on), the last one's below
GRAD_SCALES = (3.0, 0.5, 0.01)
#: the global norm's tolerance: the packages sum each leaf's squares in
#: other orders, so it may differ by a few ulps
NORM_RTOL = 1e-6


def tree(seed: int, scale: float = 1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: tree(seed + 17 * i, scale, v) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for i, (k, v) in enumerate(shapes.items())}


def ref_tree(t, dtype: str):
    return jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), t)


def port_tree(t, dtype: str):
    return params_from(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, JDT[dtype])), t), "cpu")


def leaves(t):
    """numpy leaves (float32) of a reference or port tree, in the
    reference's flatten order."""
    if isinstance(jax.tree.leaves(t)[0], torch.Tensor):
        t = params_to_numpy(t)
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in jax.tree.leaves(t)]


def assert_ulps(got, want, n: int, what: str, atol_rel: float = 0.0) -> None:
    """Every element within ``n`` float32 ulps of the reference's, plus
    ``atol_rel`` times the leaf's max|ref|."""
    for g, w in zip(leaves(got), leaves(want)):
        diff = np.abs(g - w)
        limit = n * np.spacing(np.abs(w).astype(np.float32)) + atol_rel * np.abs(w).max()
        assert (diff <= limit).all(), (what, float(diff.max()), float((diff / np.maximum(limit, 1e-45)).max()))


def bf16_ulp(w: np.ndarray) -> np.ndarray:
    """The bfloat16 spacing at each element of ``w`` (8 significand bits)."""
    a = np.maximum(np.abs(w), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def clone(t):
    return map_tensors(torch.clone, t)


def run_both(case: str, compression: bool, grad_trees):
    """Steps of both packages from ``adamw_init`` on the same params and
    gradients; yields (port params, port state, port metrics, reference
    params, reference state, reference metrics) after each step."""
    p_dt, g_dt = DTYPE_CASES[case]
    params = tree(0)
    rp, pp = ref_tree(params, p_dt), port_tree(params, p_dt)
    rs = ref_opt.adamw_init(rp, compression=compression)
    ps = opt.adamw_init(pp, compression=compression)
    assert int(ps.step) == 0 and ps.step.dtype == torch.int32
    for i, grads in enumerate(grad_trees):
        with jax.disable_jit():
            rp, rs, rm = ref_opt.adamw_update(rp, ref_tree(grads, g_dt), rs, compression=compression)
        pp, ps, pm = opt.adamw_update(pp, port_tree(grads, g_dt), ps, compression=compression)
        assert int(ps.step) == int(rs.step) == i + 1
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=NORM_RTOL)
        assert (ps.error_feedback is None) == (not compression)
        yield pp, ps, pm, rp, rs, rm


def assert_params(pp, rp, case: str, n_ulps: int, atol_rel: float, what: str) -> None:
    """float32 params within ``n_ulps`` (+ ``atol_rel``·max); bfloat16
    params within one bfloat16 rounding of that."""
    if DTYPE_CASES[case][0] == "float32":
        assert_ulps(pp, rp, n_ulps, what, atol_rel)
        return
    for g, w in zip(leaves(pp), leaves(rp)):
        limit = bf16_ulp(w) + atol_rel * np.abs(w).max()
        assert (np.abs(g - w) <= limit).all(), what


@pytest.mark.parametrize("case", DTYPE_CASES)
def test_adamw_update_matches_reference_given_the_same_norm(case):
    """The update's arithmetic: ``dyadic`` gradients, so both packages clip by
    the same scale; three steps (clipping on in the first two), params,
    ``m`` and ``v`` within 2 ulps after each."""
    for i, (pp, ps, pm, rp, rs, rm) in enumerate(run_both(case, False, [dyadic(i) for i in range(3)])):
        assert float(pm["grad_norm"]) == float(rm["grad_norm"])
        assert (float(rm["grad_norm"]) > 1.0) == (i < 2)
        assert_ulps(ps.m, rs.m, 2, f"m, step {i}")
        assert_ulps(ps.v, rs.v, 2, f"v, step {i}")
        assert_params(pp, rp, case, 2, 0.0, f"params, step {i}")


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("case", DTYPE_CASES)
def test_adamw_update_matches_reference(case, compression):
    """Three steps on normal gradients (clipping on in the first two): the
    global norms at rtol ``NORM_RTOL``; params, ``m``, ``v`` and the error
    feedback within 2 ulps plus what the norm's rounding carries into a
    clipped gradient, ``NORM_RTOL``·max|leaf| (twice that for ``v``, which
    is quadratic in it)."""
    grads = [tree(100 + i, scale) for i, scale in enumerate(GRAD_SCALES)]
    for i, (pp, ps, pm, rp, rs, rm) in enumerate(run_both(case, compression, grads)):
        assert (float(rm["grad_norm"]) > 1.0) == (i < 2)
        assert_ulps(ps.m, rs.m, 2, f"m, step {i}", NORM_RTOL)
        assert_ulps(ps.v, rs.v, 2, f"v, step {i}", 2 * NORM_RTOL)
        assert_params(pp, rp, case, 2, NORM_RTOL, f"params, step {i}")
        if compression:
            assert_ulps(ps.error_feedback, rs.error_feedback, 1, f"error feedback, step {i}", NORM_RTOL)


def test_adamw_update_works_in_place():
    """The params, moments and error feedback given are the ones returned,
    updated; the same call on clones gives the same result."""
    pp, grads = port_tree(tree(0), "float32"), port_tree(tree(1), "float32")
    state = opt.adamw_init(pp, compression=True)
    pp2, state2, g2 = clone(pp), map_tensors(torch.clone, state), clone(grads)
    new_p, new_state, _ = opt.adamw_update(pp, grads, state, compression=True)
    assert new_p["w"] is pp["w"] and new_state.m["w"] is state.m["w"]
    assert new_state.error_feedback["w"] is state.error_feedback["w"]
    assert not torch.equal(pp2["w"], pp["w"]) and float(state.m["w"].abs().sum()) > 0
    again, again_state, _ = opt.adamw_update(pp2, g2, state2, compression=True)
    for a, b in zip(leaves(again), leaves(new_p)):
        np.testing.assert_array_equal(a, b)


def dyadic(i: int):
    """Gradients of multiples of 2^-k (k = 3, 6, 14 for i = 0, 1, 2): their
    squares sum exactly in float32 in any order, so the global norm, and
    the clip scale, do not depend on the order of the sum."""
    rng = np.random.default_rng(100 + i)
    k = (3, 6, 14)[i]
    return jax.tree.map(lambda a: (rng.integers(-24, 25, a.shape) / 2.0 ** k).astype(np.float32), tree(0))


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "compressed"])
def test_update_in_chunks_matches_one_chunk(monkeypatch, compression):
    """A leaf updated a chunk at a time gets the same bits as in one go
    (the global norm is summed per chunk: the gradients are ``dyadic``);
    with compression on, the decompressed gradients and the error feedback
    are bitwise equal, and the rest within the norm's rtol."""
    def run():
        pp = port_tree(tree(0), "bfloat16")
        grads = port_tree(dyadic(0), "float32")
        out = opt.adamw_update(pp, grads, opt.adamw_init(pp, compression=compression),
                               compression=compression)
        return out, grads

    (whole, g_whole) = run()
    monkeypatch.setattr(opt, "CHUNK", 7)
    (chunked, g_chunked) = run()
    pairs = [(g_chunked, g_whole)]
    if compression:
        pairs.append((chunked[1].error_feedback, whole[1].error_feedback))
    else:
        pairs += [(chunked[0], whole[0]), (chunked[1].m, whole[1].m), (chunked[1].v, whole[1].v)]
    for ta, tb in pairs:
        for a, b in zip(leaves(ta), leaves(tb)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(chunked[2]["grad_norm"]), float(whole[2]["grad_norm"]), rtol=NORM_RTOL)
    assert_ulps(chunked[1].m, whole[1].m, 2, "m", NORM_RTOL)


def test_adamw_update_without_error_feedback_raises():
    pp = port_tree(tree(0), "float32")
    with pytest.raises(ValueError):
        opt.adamw_update(pp, port_tree(tree(1), "float32"), opt.adamw_init(pp), compression=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 0.3, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    grads = tree(7, 2.0)
    with jax.disable_jit():
        rc, rn = ref_opt.clip_by_global_norm(ref_tree(grads, dtype), max_norm)
    pc, pn = opt.clip_by_global_norm(port_tree(grads, dtype), max_norm)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    assert jax.tree.map(lambda a: a.dtype, rc) == jax.tree.map(lambda a: JDT[dtype], rc)
    assert all(t.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
               for t in jax.tree.leaves(pc))
    for a, b in zip(leaves(pc), leaves(rc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["normal", "wide", "zeros", "one"])
def test_quantize_int8_matches_reference_bitwise(case):
    rng = np.random.default_rng(3)
    x = {"normal": rng.normal(0, 1, 512), "wide": rng.normal(0, 1, 4096) * np.exp(rng.normal(0, 4, 4096)),
         "zeros": np.zeros(64), "one": np.ones(1)}[case].astype(np.float32)
    with jax.disable_jit():
        rq, rs = ref_opt.quantize_int8(jnp.asarray(x))
        rd = ref_opt.dequantize_int8(rq, rs)
    q, s = opt.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(opt.dequantize_int8(q, s).numpy(), np.asarray(rd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_matches_reference(dtype):
    """Five rounds carrying the residual: the decompressed gradients
    bitwise (in the gradients' dtype), the residual within 1 ulp; the
    inputs are left as they were."""
    re = pe = None
    for i in range(5):
        grads = tree(20 + i, 1.5)
        if re is None:
            re = jax.tree.map(jnp.zeros_like, ref_tree(grads, "float32"))
            pe = port_tree(jax.tree.map(np.zeros_like, grads), "float32")
        with jax.disable_jit():
            rg, re = ref_opt.compress_decompress(ref_tree(grads, dtype), re)
        pg_in = port_tree(grads, dtype)
        before = clone(pg_in), clone(pe)
        pg, pe_new = opt.compress_decompress(pg_in, pe)
        for a, b in zip(leaves(pg_in) + leaves(pe), leaves(before[0]) + leaves(before[1])):
            np.testing.assert_array_equal(a, b)
        pe = pe_new
        assert all(t.dtype == pg_in["w"].dtype for t in jax.tree.leaves(pg))
        for a, b in zip(leaves(pg), leaves(rg)):
            np.testing.assert_array_equal(a, b)
        assert_ulps(pe, re, 1, f"residual, round {i}")


# ---------------------------------------------------------------------------
# the reference's own optimizer tests (tests/test_infra.py), on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.adamw_update(params, grads, state, lr=3e-2, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_gradient_compression_error_feedback_unbiased():
    """With error feedback, the *accumulated* compressed updates track the
    accumulated true gradients (residual stays bounded)."""
    rng = np.random.default_rng(0)
    ef = {"g": torch.zeros(256)}
    total_true = np.zeros(256)
    total_sent = np.zeros(256)
    for _ in range(50):
        g = {"g": torch.from_numpy(rng.normal(0, 1, 256).astype(np.float32))}
        total_true += g["g"].numpy()
        sent, ef = opt.compress_decompress(g, ef)
        total_sent += sent["g"].numpy()
    # residual is bounded by one quantization step, not growing with steps
    assert np.abs(total_true - total_sent).max() < 0.2


def test_quantize_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 2, 512).astype(np.float32))
    q, scale = opt.quantize_int8(x)
    err = float((opt.dequantize_int8(q, scale) - x).abs().max())
    assert err <= float(scale) * 0.5 + 1e-7
    assert q.dtype == torch.int8


def test_compressed_training_still_converges():
    target = torch.tensor([0.5, -1.5, 2.5])
    params = {"w": torch.zeros(3)}
    state = opt.adamw_init(params, compression=True)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.adamw_update(params, grads, state, lr=3e-2, weight_decay=0.0,
                                            compression=True)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=5e-2)


def test_grad_clip_global_norm():
    clipped, norm = opt.clip_by_global_norm({"a": torch.ones(4) * 10.0}, max_norm=1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.vector_norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)
