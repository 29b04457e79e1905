"""The port's LM serving path (``repro_torch.models.transformer``,
``ModelConfig.n_params``, ``repro_torch.configs.shapes``) against the
reference's, over all ten ``SMOKE`` configs (``tests/test_arch_smoke.py``'s
forward and decode tests, without its train step).

Params come from the reference's ``init_params(PRNGKey(0), cfg)`` through
``repro_torch.convert.params_from``; tokens (and audio frames and patch
embeddings) from numpy seeds.  The reference runs op by op
where a bfloat16 routing is compared (``jax.disable_jit``, the MoE configs):
its ``lax.scan`` bodies compiled whole fuse bfloat16 chains and round apart
from eager torch by an ulp, which can flip a routing; op by op the two
agree bit for bit.  Elsewhere it runs under ``jax.jit``.
Every check runs twice: with the params cast to float32 (and the config's
``param_dtype`` float32) within 2e-5·max|ref|, and at the config's bfloat16
at the reference's bound, rtol 0.1 / atol 0.15.  MoE stats are exact in
both.  A decode state is compared leaf by leaf at the same bounds, its
lengths and position exactly.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.configs import shapes
from repro_torch._device import map_tensors
from repro_torch.convert import decode_state_from, decode_state_to_numpy, params_from
from repro_torch.models import decode_step, forward_train, init_decode_state, init_params, prefill
from test_torch_attention import DTYPES, assert_close, f32

B, S = 2, 16
STAT_KEYS = ("aux_loss", "tokens_per_expert", "slots_filled")
#: decode steps of the from-scratch trace; the carried state is taken after MID
N_STEPS, MID = 3, 2


def configs(arch: str, dtype: str):
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        ref_cfg, cfg = ref_cfg.scaled(param_dtype=jnp.float32), cfg.scaled(param_dtype=torch.float32)
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    """The reference's ``init_params(PRNGKey(0), cfg)``, compiled; the specs
    (plain tuples) are kept from the trace."""
    cfg, specs = ref_get_config(arch, smoke=True), {}

    def init(key):
        params, specs["tree"] = ref_init_params(key, cfg)
        return params

    return jax.jit(init)(jax.random.PRNGKey(0)), specs["tree"]


@functools.lru_cache(maxsize=None)
def case(arch: str, dtype: str):
    """(reference cfg, port cfg, reference params, port params, numpy batch)."""
    ref_cfg, cfg = configs(arch, dtype)
    rp = ref_params(arch)[0]
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.kind == "encdec":
        batch["audio_embed"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches > 0:
        batch["patch_embeds"] = rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, rp, params_from(jax.tree.map(np.asarray, rp), "cpu"), batch


def ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.bfloat16) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.from_numpy(v) if k == "tokens" else torch.from_numpy(v).bfloat16()
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ref_trace(arch: str, dtype: str):
    """The reference's forward, prefill, one decode step from a filled
    state, and N_STEPS steps from scratch (logits and states).  The MoE
    configs at bfloat16 run op by op, so that their routing sees the port's
    bits; everything else runs under ``jax.jit`` (one compile per
    function), whose fused rounding stays far inside the bounds."""
    ref_cfg, _, rp, _, batch = case(arch, dtype)
    rb = ref_batch(batch)
    pre = jax.jit(lambda p, b: ref_prefill(p, ref_cfg, b))(rp, rb)
    if dtype == "float32" or not ref_cfg.n_experts:
        fwd = jax.jit(lambda p, b: ref_forward(p, ref_cfg, b))
        dec = jax.jit(lambda p, t, s: ref_decode_step(p, ref_cfg, t, s))
        ctx = contextlib.nullcontext()
    else:
        fwd = lambda p, b: ref_forward(p, ref_cfg, b)  # noqa: E731
        dec = lambda p, t, s: ref_decode_step(p, ref_cfg, t, s)  # noqa: E731
        ctx = jax.disable_jit()
    with ctx:
        logits, stats = fwd(rp, rb)
        filled = dec(rp, rb["tokens"][:, :1], ref_init_decode_state(ref_cfg, B, S, filled=True))
        st = ref_init_decode_state(ref_cfg, B, S, filled=False)
        steps = []
        for i in range(N_STEPS):
            out, st = dec(rp, rb["tokens"][:, i : i + 1], st)
            steps.append((out, st))
    return logits, stats, pre, filled, steps


def _leaf(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a)


def flat_state(state) -> dict:
    """A decode state (the port's or the reference's) as {path: numpy
    array}, floating leaves in float32."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, f"{path}/{k}")
        else:
            out[path] = _leaf(node)

    walk(state, "")
    return out


def assert_state_matches(got, ref, dtype: str, label: str = "") -> None:
    g, r = flat_state(got), flat_state(ref)
    assert g.keys() == r.keys(), (label, sorted(g.keys() ^ r.keys()))
    for k in r:
        assert g[k].shape == r[k].shape, (label, k, g[k].shape, r[k].shape)
        if r[k].dtype.kind in "iu":
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{label} {k}")
        else:
            assert_close(g[k], r[k], dtype, err_msg=f"{label} {k}")


def _tensors(tree):
    out = []
    map_tensors(out.append, tree)
    return out


def tree_meta(tree, path=""):
    """{path: (shape, dtype name)} of a params tree (jax or torch leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_meta(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_tree_matches_reference(arch):
    """Converted params keep the reference's keys, shapes and dtypes; the
    port's own ``init_params`` (drawn from a torch generator) builds the
    same tree, with the same specs, and so does the ``meta`` path."""
    rp, rspecs = ref_params(arch)
    cfg = get_config(arch, smoke=True)
    want = tree_meta(rp)
    assert tree_meta(params_from(jax.tree.map(np.asarray, rp), "cpu")) == want
    params, specs = init_params(torch.Generator().manual_seed(0), cfg)
    assert tree_meta(params) == want
    assert specs == rspecs
    meta, _ = init_params(None, cfg, device="meta")
    assert tree_meta(meta) == want
    assert all(t.is_meta for t in _tensors(meta))
    assert all(bool(torch.isfinite(t.float()).all()) for t in _tensors(params))


def test_init_params_stacks_distinct_layers():
    """Each layer of a stack is its own draw; the seed fixes the params."""
    cfg = get_config("qwen3-14b", smoke=True)
    a, _ = init_params(torch.Generator().manual_seed(0), cfg)
    b, _ = init_params(torch.Generator().manual_seed(0), cfg)
    wq = a["blocks"]["a0"]["attn"]["wq"]
    assert wq.shape[0] == cfg.n_layers and not torch.equal(wq[0], wq[1])
    assert torch.equal(wq, b["blocks"]["a0"]["attn"]["wq"])
    assert float(wq.float().std()) == pytest.approx(0.8796 / np.sqrt(cfg.d_model), rel=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, dtype):
    _, cfg, _, pp, batch = case(arch, dtype)
    logits_r, stats_r = ref_trace(arch, dtype)[:2]
    logits, stats = forward_train(pp, cfg, port_batch(batch))
    assert logits.shape == (B, S, cfg.vocab_padded) and logits.dtype == cfg.param_dtype
    assert_close(logits, logits_r, dtype)
    assert sorted(stats) == sorted(stats_r) == (sorted(STAT_KEYS) if cfg.n_experts else [])
    for key in ("tokens_per_expert", "slots_filled"):
        if key in stats:
            np.testing.assert_array_equal(stats[key].numpy(), np.asarray(stats_r[key]), err_msg=key)
    if "aux_loss" in stats:
        np.testing.assert_allclose(float(stats["aux_loss"]), float(stats_r["aux_loss"]), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch, dtype):
    _, cfg, _, pp, batch = case(arch, dtype)
    got = prefill(pp, cfg, port_batch(batch))
    assert got.shape == (B, cfg.vocab_padded)
    assert_close(got, ref_trace(arch, dtype)[2], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_from_filled_state_matches_reference(arch, dtype):
    """One step from ``init_decode_state(filled=True)``: the global caches'
    first write wraps to slot 0, as the reference's does."""
    _, cfg, _, pp, batch = case(arch, dtype)
    logits_r, state_r = ref_trace(arch, dtype)[3]
    state = init_decode_state(cfg, B, S, filled=True, device="cpu")
    logits, state = decode_step(pp, cfg, torch.from_numpy(batch["tokens"][:, :1]), state)
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert int(state.position) == S + 1
    assert_close(logits, logits_r, dtype)
    assert_state_matches(state, state_r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_from_scratch_matches_reference(arch, dtype):
    """N_STEPS steps from ``filled=False``: logits and the whole state after
    every step, the position advancing by one each time."""
    _, cfg, _, pp, batch = case(arch, dtype)
    state = init_decode_state(cfg, B, S, filled=False, device="cpu")
    for i, (logits_r, state_r) in enumerate(ref_trace(arch, dtype)[4]):
        tok = torch.from_numpy(batch["tokens"][:, i : i + 1])
        logits, state = decode_step(pp, cfg, tok, state)
        assert int(state.position) == i + 1
        assert_close(logits, logits_r, dtype, err_msg=f"step {i}")
        assert_state_matches(state, state_r, dtype, label=f"step {i}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_continues_a_carried_reference_state(arch, dtype):
    """The reference's state after MID steps, carried across by
    ``decode_state_from``, decodes the next steps as the reference does;
    and ``decode_state_to_numpy`` gives the reference's leaves back."""
    _, cfg, _, pp, batch = case(arch, dtype)
    steps = ref_trace(arch, dtype)[4]
    state = decode_state_from(steps[MID - 1][1], "cpu")
    assert isinstance(state.position, torch.Tensor) and int(state.position) == MID
    back, want = flat_state(decode_state_to_numpy(state)), flat_state(steps[MID - 1][1])
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    for i in range(MID, N_STEPS):
        tok = torch.from_numpy(batch["tokens"][:, i : i + 1])
        logits, state = decode_step(pp, cfg, tok, state)
        assert_close(logits, steps[i][0], dtype, err_msg=f"step {i}")
        assert_state_matches(state, steps[i][1], dtype, label=f"step {i}")


def test_decode_step_consumes_its_state():
    """The KV caches are written in place, the state comes back with
    position + 1, and a clone taken before decodes the same step again."""
    _, cfg, _, pp, batch = case("recurrentgemma-9b", "float32")
    state = init_decode_state(cfg, B, S, filled=False, device="cpu")
    saved = map_tensors(torch.clone, state)
    tok = torch.from_numpy(batch["tokens"][:, :1])
    logits, new = decode_step(pp, cfg, tok, state)
    assert new.caches["a2"]["kv"].k is state.caches["a2"]["kv"].k
    assert float(state.caches["a2"]["kv"].k.abs().sum()) > 0
    assert int(new.position) == 1 and int(state.position) == 0
    again, _ = decode_step(pp, cfg, tok, saved)
    assert torch.equal(again, logits)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_decode_matches_forward_tail(arch, dtype):
    """For the stateful archs, decoding token by token from a fresh state
    matches the full-sequence forward at the last position, at the bound of
    the reference's own test (``tests/test_arch_smoke.py``; mamba2 with
    ``ssm_chunk = 4``) in both runs: the KV caches hold bfloat16 whatever
    the params' dtype, so recurrentgemma's local attention differs from the
    forward's by bfloat16 rounding even with float32 params."""
    _, cfg, _, pp, _ = case(arch, dtype)
    if arch == "mamba2-780m":
        cfg = cfg.scaled(ssm_chunk=4)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 8)).astype(np.int32))
    logits_full, _ = forward_train(pp, cfg, {"tokens": tokens})
    st = init_decode_state(cfg, 1, 8, filled=False, device="cpu")
    for i in range(8):
        logits_step, st = decode_step(pp, cfg, tokens[:, i : i + 1], st)
    np.testing.assert_allclose(f32(logits_step[0, 0]), f32(logits_full[0, -1]), rtol=0.1, atol=0.15)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_matches_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert cfg.n_params == ref_cfg.n_params


def _spec_meta(tree):
    out = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, f"{path}/{k}")
        else:
            out[path] = (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    walk(tree, "")
    return out


@pytest.mark.parametrize("shape", list(ref_shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    """Shapes and dtypes of every input at the full configs, and the same
    applicability verdicts; the port's stand-ins are ``meta`` tensors."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert shapes.applicable(cfg, shape) == ref_shapes.applicable(ref_cfg, shape)
    assert shapes.SHAPES[shape].__dict__ == ref_shapes.SHAPES[shape].__dict__
    got = shapes.input_specs(cfg, shape, batch_override=4)
    want = ref_shapes.input_specs(ref_cfg, shape, batch_override=4)
    if "state" in want:
        want = dict(want, state=want["state"]._asdict())
        got = dict(got, state=got["state"]._asdict())
    assert _spec_meta(got) == _spec_meta(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_allocate_nothing(arch):
    cfg = get_config(arch)
    state = shapes.decode_state_specs(cfg, 128, 32_768)
    leaves = _tensors(state)
    assert leaves and all(t.is_meta for t in leaves)
