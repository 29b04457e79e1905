"""The port's training path (``repro_torch.models.loss_fn``,
``repro_torch.train.trainstep``, the per-layer remat in
``models/transformer.py``) against the reference's, over the ``SMOKE``
configs.

Params are drawn by the port's ``init_params`` from a seeded generator
(the reference's tree, ``tests/test_torch_transformer.py``) and reach the
reference as numpy arrays, which spares compiling the reference's init;
batches come from ``SyntheticLMData`` (bitwise the same in both packages,
``tests/test_torch_data.py``).  The reference runs under ``jax.jit``.
Tolerances:

  * ``loss_fn`` with float32 params: loss and ``ce_loss`` at rtol 1e-5,
    ``n_tokens`` and the MoE stats exact;
  * gradients, per leaf: |Δ| ≤ 1e-4·|g_ref| + ``GRAD_ATOL_REL_BY_ARCH``·
    max|g_ref|: the form of the bound ``tests/test_torch_moe.py`` measured
    for the MoE block's gradients (``GRAD_ATOL_REL``, 1.5e-6, twice that
    block's float32-vs-float64 gap), with each config's atol twice its own
    gap as ``test_float32_gradient_gap_within_tolerance`` measures it
    (1.8e-6 to 8.3e-6: every config's gap is above half of 1.5e-6);
  * the flash path's gradients, with explicit blocks in both packages, at
    the same bound against ``jax.grad``, and against the port's ``_sdpa``
    at the reference's own atol 3e-5 (``tests/test_infra.py``);
  * ``make_train_step`` over 3 steps with float32 params: losses and
    ``grad_norm`` at rtol 1e-5, params within ``2·lr·n_steps`` per element
    (in the first steps AdamW moves an element by about ``lr·sign(g)``,
    and a gradient within rounding of 0 may take the other sign in the
    other package), with the share of elements beyond 1e-5·max|p| held
    under 1e-3 and reported;
  * with bfloat16 params (``tests/test_arch_smoke.py``'s train step): the
    loss finite and within rtol 1e-2 of the reference's, ``opt.step == 1``,
    the params changed;
  * restart through the port's ``CheckpointManager``: exact on the CPU;
    from a reference checkpoint: the reference's next losses at rtol 1e-5.
"""
import contextlib
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import ARCH_IDS
from repro.data import SyntheticLMData as RefData
from repro.models import attention as ref_attn
from repro.models import loss_fn as ref_loss_fn
from repro.train.trainstep import init_train_state as ref_init_train_state
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch._device import map_tensors
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import params_from, params_to_numpy, train_state_from, train_state_to_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.models import attention as attn
from repro_torch.models import init_params, loss_fn
from repro_torch.models import transformer
from repro_torch.models.common import rope_freqs
from repro_torch.train.trainstep import TrainState, init_train_state, make_train_step
from test_torch_transformer import configs

#: gradient atol relative to each leaf's max|g| (``tests/test_torch_moe.py``'s
#: bound, twice the MoE block's float32-vs-float64 gap)
GRAD_ATOL_REL = 1.5e-6
#: each config's bound: twice the largest float32-vs-float64 gradient gap
#: measured by ``test_float32_gradient_gap_within_tolerance`` (the port's
#: or the reference's float32 gradients against the port's float64 ones,
#: relative to the leaf's max|g|), rounded up to two digits; every config's gap is above
#: GRAD_ATOL_REL / 2, so none keeps it
GRAD_ATOL_REL_BY_ARCH = {
    "recurrentgemma-9b": 2.5e-6,  # gap 1.22e-6 (the reference's)
    "whisper-medium": 2.0e-6,  # 9.66e-7 (the reference's)
    "qwen3-14b": 1.9e-6,  # 9.12e-7 (the reference's)
    "yi-9b": 1.8e-6,  # 8.79e-7 (the reference's)
    "phi3-medium-14b": 1.8e-6,  # 8.79e-7 (the reference's)
    "qwen2.5-32b": 2.7e-6,  # 1.32e-6 (the port's)
    "mamba2-780m": 5.4e-6,  # 2.67e-6 (the reference's)
    "mixtral-8x7b": 2.1e-6,  # 1.04e-6 (the port's)
    "llama4-scout-17b-a16e": 8.3e-6,  # 4.12e-6 (the reference's)
    "qwen2-vl-72b": 2.2e-6,  # 1.06e-6 (the reference's)
}
B, S = 4, 16
DATA_SEED = 3
LR = 3e-4
N_STEPS = 3
STAT_KEYS = ("tokens_per_expert", "slots_filled")


@functools.lru_cache(maxsize=None)
def numpy_params(arch: str, dtype: str = "float32"):
    """The port's ``init_params`` (seed 0) at ``dtype`` as a numpy tree
    (bfloat16 values held exactly in float32)."""
    return params_to_numpy(init_params(torch.Generator().manual_seed(0), configs(arch, dtype)[1])[0])


def ref_tree(arch: str, dtype: str = "float32"):
    return jax.tree.map(lambda a: jnp.asarray(a, configs(arch, dtype)[0].param_dtype), numpy_params(arch, dtype))


def port_tree(arch: str, dtype: str = "float32"):
    """A fresh copy (the train step consumes its state)."""
    tdt = configs(arch, dtype)[1].param_dtype
    return map_tensors(lambda t: t.to(tdt), params_from(numpy_params(arch, dtype), "cpu"))


def numpy_leaves(tree):
    """Leaves in the reference's flatten order as numpy (float32 for
    bfloat16), from a reference tree or a port tree."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = params_to_numpy(tree)
    return [np.asarray(jnp.asarray(a, jnp.float32) if jnp.asarray(a).dtype == jnp.bfloat16 else a)
            for a in jax.tree.leaves(tree)]


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch: str):
    """The reference's loss, metrics and gradients (numpy leaves) with
    float32 params on the data's step-0 batch."""
    ref_cfg, _ = configs(arch, "float32")
    batch = RefData(ref_cfg, B, S, seed=DATA_SEED).batch_at(0)
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref_loss_fn(p, ref_cfg, b), has_aux=True))
    (loss, metrics), grads = fn(ref_tree(arch), batch)
    return float(loss), jax.tree.map(np.asarray, metrics), numpy_leaves(grads)


@contextlib.contextmanager
def float64_model():
    """Inside, ``Tensor.float()`` leaves a float64 tensor as it is, so a
    model run with float64 params and inputs computes in float64 where the
    float32 run casts to float32 (norms, RoPE, scores, the SSD scan).  The
    cached RoPE frequencies are dropped on the way in and out, so neither
    run reuses the other's."""
    orig = torch.Tensor.float
    rope_freqs.cache_clear()
    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 else orig(self, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = orig
        rope_freqs.cache_clear()


def port_loss_and_grads(arch: str, dtype=torch.float32):
    """The port's loss, metrics and gradients (numpy leaves, flatten order)
    with ``dtype`` params on the same batch."""
    _, cfg = configs(arch, "float32")
    cfg = cfg.scaled(param_dtype=dtype)
    params = map_tensors(lambda t: t.to(dtype), port_tree(arch))
    batch = SyntheticLMData(cfg, B, S, seed=DATA_SEED, device="cpu").batch_at(0)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    leaves = jax.tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with float64_model() if dtype == torch.float64 else contextlib.nullcontext():
        loss, metrics = loss_fn(params, cfg, batch)
        loss.backward()
    grads = [np.zeros(p.shape) if p.grad is None else p.grad.double().numpy() for p in leaves]
    return float(loss.detach()), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches_reference(arch):
    loss_r, metrics_r, _ = ref_loss_and_grads(arch)
    loss, metrics, _ = port_loss_and_grads(arch)
    assert sorted(metrics) == sorted(metrics_r)
    np.testing.assert_allclose(loss, loss_r, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"]), float(metrics_r["ce_loss"]), rtol=1e-5)
    assert float(metrics["n_tokens"]) == float(metrics_r["n_tokens"]) == B * (S - 1)
    if "moe_aux_loss" in metrics:
        np.testing.assert_allclose(float(metrics["moe_aux_loss"]), float(metrics_r["moe_aux_loss"]), rtol=1e-6)
        for key in STAT_KEYS:
            np.testing.assert_array_equal(metrics[key].numpy(), metrics_r[key], err_msg=key)


def test_loss_fn_masks_padded_vocab_and_unlabelled_tokens():
    """With a vocab of 500 padded to 512 (no SMOKE config pads; Qwen3-14B
    does, 151,936 to 152,064): the loss matches the reference's at rtol
    1e-5, logits in the padded columns do not reach it, and neither do
    positions labelled -1; labels stay int32."""
    ref_cfg, cfg = (c.scaled(vocab=500) for c in configs("qwen3-14b", "float32"))
    assert cfg.vocab_padded == 512
    pp = port_tree("qwen3-14b")
    batch = SyntheticLMData(cfg, B, S, seed=DATA_SEED, device="cpu").batch_at(0)
    loss, metrics = loss_fn(pp, cfg, batch)
    ref_batch = RefData(ref_cfg, B, S, seed=DATA_SEED).batch_at(0)
    want = jax.jit(lambda p, b: ref_loss_fn(p, ref_cfg, b)[0])(ref_tree("qwen3-14b"), ref_batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    boosted = dict(pp, lm_head=pp["lm_head"].clone())
    boosted["lm_head"][:, cfg.vocab:] = 1e3
    assert torch.equal(loss_fn(boosted, cfg, batch)[0], loss)
    masked = dict(batch, labels=torch.where(torch.arange(S) < 4, batch["labels"], -1))
    assert masked["labels"].dtype == torch.int32
    _, m = loss_fn(pp, cfg, masked)
    assert float(m["n_tokens"]) == B * 4 and float(metrics["n_tokens"]) == B * (S - 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_reference(arch):
    """``torch`` autograd through ``loss_fn`` against ``jax.grad``, per
    leaf: |Δ| ≤ 1e-4·|g_ref| + GRAD_ATOL_REL_BY_ARCH[arch]·max|g_ref|."""
    _, _, g_ref = ref_loss_and_grads(arch)
    _, _, g = port_loss_and_grads(arch)
    assert [a.shape for a in g] == [b.shape for b in g_ref]
    for i, (a, b) in enumerate(zip(g, g_ref)):
        atol = GRAD_ATOL_REL_BY_ARCH[arch] * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_gradient_gap_within_tolerance(arch):
    """The measurement behind the gradient bound: the port's gradients with
    float64 params and inputs (``float64_model``) against the float32
    gradients of the port and of the reference, each gap relative to the
    leaf's max|g|: at most 8.79e-7 (yi) to 4.12e-6 (Scout), the larger of
    the two packages' gaps.  Each config's bound is at least twice it."""
    _, _, g64 = port_loss_and_grads(arch, torch.float64)
    g32 = [port_loss_and_grads(arch)[2], ref_loss_and_grads(arch)[2]]
    worst = max(float(np.abs(g[i] - b).max() / np.abs(b).max())
                for g in g32 for i, b in enumerate(g64) if np.abs(b).max() > 0)
    assert 1e-9 < worst and 2 * worst <= GRAD_ATOL_REL_BY_ARCH[arch], worst


FLASH_VARIANTS = {"causal": (None, None), "window": (8, None), "chunk": (None, 8)}


@pytest.mark.parametrize("blocks", [(16, 16), (8, 8)], ids=["16x16", "8x8"])
@pytest.mark.parametrize("variant", FLASH_VARIANTS)
def test_flash_gradients_match_reference(variant, blocks):
    """Gradients of q, k and v through ``_flash_sdpa`` with explicit blocks
    in both packages (GQA, 4 heads on 2 KV heads, 32 tokens), against
    ``jax.grad`` at the gradient bound and against the port's ``_sdpa`` at
    the reference's own atol 3e-5."""
    window, chunk = FLASH_VARIANTS[variant]
    q_block, kv_block = blocks
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8)))
    cot = rng.standard_normal((1, 32, 4, 8)).astype(np.float32)

    def ref_f(q_, k_, v_):
        out = ref_attn._flash_sdpa(q_, k_, v_, causal=True, window=window, chunk=chunk,
                                   q_block=q_block, kv_block=kv_block)
        return (out * cot).sum()

    g_ref = jax.jit(jax.grad(ref_f, argnums=(0, 1, 2)))(q, k, v)

    def port_grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (fn(*ts) * torch.from_numpy(cot)).sum().backward()
        return [t.grad.numpy() for t in ts]

    flash = port_grads(lambda a, b, c: attn._flash_sdpa(a, b, c, causal=True, window=window, chunk=chunk,
                                                        q_block=q_block, kv_block=kv_block))
    mask = attn._mask(32, 32, 0, True, window, chunk)
    naive = port_grads(lambda a, b, c: attn._sdpa(a, b, c, mask))
    for name, a, b, c in zip("qkv", flash, g_ref, naive):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=GRAD_ATOL_REL * float(np.abs(b).max()), err_msg=name)
        np.testing.assert_allclose(a, c, atol=3e-5, err_msg=name)


def test_per_layer_remat_checkpoints_each_group_only_while_recording(monkeypatch):
    """Each stacked group runs under ``torch.utils.checkpoint`` while
    autograd records and not under ``no_grad``; the gradients are those
    of the run without it, bit for bit."""
    arch = "recurrentgemma-9b"  # a hybrid pattern: stacked groups and tail blocks
    calls = []
    real = transformer.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    _, _, g = port_loss_and_grads(arch)
    _, cfg = configs(arch, "float32")
    n_groups = cfg.n_layers // len(cfg.block_pattern)
    assert len(calls) == n_groups and all(kw["use_reentrant"] is False for kw in calls)
    pp = port_tree(arch)
    with torch.no_grad():
        transformer.forward_train(pp, cfg, SyntheticLMData(cfg, B, S, device="cpu").batch_at(0))
    assert len(calls) == n_groups
    monkeypatch.setattr(transformer, "checkpoint", lambda fn, *args, **kw: fn(*args))
    _, _, g_plain = port_loss_and_grads(arch)
    for a, b in zip(g, g_plain):
        np.testing.assert_array_equal(a, b)


def run_steps(arch: str, grad_accum: int, compression: bool, n_steps: int = N_STEPS, remat: bool = False):
    """``n_steps`` of both packages from the same float32 state on the same
    batches: (port metrics per step, reference metrics per step, port
    state, reference state)."""
    ref_cfg, cfg = configs(arch, "float32")
    rs = ref_init_train_state(ref_tree(arch), compression=compression)
    ps = train_state_from(jax.tree.map(np.asarray, rs), "cpu")
    ref_step = jax.jit(ref_make_train_step(ref_cfg, grad_accum=grad_accum, lr=LR, compression=compression))
    step = make_train_step(cfg, grad_accum=grad_accum, lr=LR, compression=compression, remat=remat)
    ref_data, data = RefData(ref_cfg, B, S, seed=5), SyntheticLMData(cfg, B, S, seed=5, device="cpu")
    pm, rm = [], []
    for s in range(n_steps):
        rs, m_r = ref_step(rs, ref_data.batch_at(s))
        ps, m = step(ps, data.batch_at(s))
        rm.append(jax.tree.map(np.asarray, m_r))
        pm.append({k: v.numpy() for k, v in m.items()})
    return pm, rm, ps, rs


TRAIN_CASES = [("yi-9b", 1, False), ("yi-9b", 2, False), ("yi-9b", 1, True), ("yi-9b", 2, True),
               ("llama4-scout-17b-a16e", 1, True), ("mamba2-780m", 2, False)]


@pytest.mark.parametrize("arch,grad_accum,compression", TRAIN_CASES,
                         ids=[f"{a}-accum{g}-{'compressed' if c else 'plain'}" for a, g, c in TRAIN_CASES])
def test_train_steps_match_reference(arch, grad_accum, compression):
    pm, rm, ps, rs = run_steps(arch, grad_accum, compression)
    for s, (m, m_r) in enumerate(zip(pm, rm)):
        # the reference's metrics: no ce_loss / moe_aux_loss under grad_accum > 1
        assert sorted(m) == sorted(m_r), s
        for k in m_r:
            np.testing.assert_allclose(m[k], m_r[k], rtol=1e-5, err_msg=f"{k} step {s}")
    assert int(ps.opt.step) == int(rs.opt.step) == N_STEPS
    assert (ps.opt.error_feedback is None) == (not compression)
    got, want = numpy_leaves(ps.params), numpy_leaves(rs.params)
    limit = 2 * LR * N_STEPS
    far = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        d = np.abs(a - b)
        assert d.max() <= limit, (i, float(d.max()), limit)
        far += int((d > 1e-5 * np.abs(b).max()).sum())
        total += d.size
    assert far / total < 1e-3, f"{far} of {total} params beyond 1e-5·max|p|"
    print(f"{arch} accum {grad_accum} compression {compression}: {far} of {total} params "
          f"({far / total:.2e}) beyond 1e-5·max|p|")


def make_batch(cfg, B=2, S=16, seed=0):
    """``tests/test_arch_smoke.py``'s batch: random tokens and labels."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.kind == "encdec":
        batch["audio_embed"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches > 0:
        batch["patch_embeds"] = rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """``tests/test_arch_smoke.py::test_smoke_train_step`` on the port, at
    the configs' bfloat16: one step with ``grad_accum=2``; the loss finite
    and within rtol 1e-2 of the reference's (the mean of its two
    microbatch losses), ``opt.step == 1``, the params changed."""
    ref_cfg, cfg = configs(arch, "bfloat16")
    rp = ref_tree(arch, "bfloat16")
    batch = make_batch(cfg, B=4)
    ref_batch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32 else jnp.bfloat16) for k, v in batch.items()}
    ref_loss = jax.jit(lambda p, b: ref_loss_fn(p, ref_cfg, b)[0])
    want = np.mean([float(ref_loss(rp, {k: v[i * 2 : (i + 1) * 2] for k, v in ref_batch.items()})) for i in range(2)])
    params = port_tree(arch, "bfloat16")
    before = numpy_leaves(params)[0].copy()
    state = init_train_state(params)
    port_batch = {k: torch.from_numpy(v) if v.dtype == np.int32 else torch.from_numpy(v).bfloat16()
                  for k, v in batch.items()}
    new_state, metrics = make_train_step(cfg, grad_accum=2)(state, port_batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want, rtol=1e-2)
    assert int(new_state.opt.step) == 1
    assert not np.allclose(before, numpy_leaves(new_state.params)[0])


def test_train_step_consumes_its_state():
    """The params, ``m`` and ``v`` are updated in place and returned in the
    new state; the params carry no autograd state after the step; a clone
    taken before steps to the same bits."""
    _, cfg = configs("yi-9b", "float32")
    state = init_train_state(port_tree("yi-9b"))
    saved = map_tensors(torch.clone, state)
    batch = SyntheticLMData(cfg, B, S, device="cpu").batch_at(0)
    step = make_train_step(cfg)
    new, _ = step(state, batch)
    old_leaves, new_leaves = jax.tree.leaves(state.params), jax.tree.leaves(new.params)
    assert all(a is b for a, b in zip(old_leaves, new_leaves))
    assert new.opt.m["embed"] is state.opt.m["embed"] and new.opt.v["embed"] is state.opt.v["embed"]
    assert not torch.equal(saved.params["embed"], state.params["embed"])
    assert all(not p.requires_grad and p.grad is None for p in new_leaves)
    assert int(new.opt.step) == 1 and int(state.opt.step) == 0
    again, _ = step(saved, batch)
    for a, b in zip(numpy_leaves(again.params), numpy_leaves(new.params)):
        np.testing.assert_array_equal(a, b)


def test_whole_loss_remat_gives_the_same_step():
    """``remat=True`` (the whole loss checkpointed over the per-layer
    checkpoints) computes the same step, bit for bit on the CPU."""
    _, cfg = configs("mixtral-8x7b", "float32")
    state = init_train_state(port_tree("mixtral-8x7b"))
    twin = map_tensors(torch.clone, state)
    batch = SyntheticLMData(cfg, B, S, device="cpu").batch_at(0)
    a, ma = make_train_step(cfg, grad_accum=2)(state, batch)
    b, mb = make_train_step(cfg, grad_accum=2, remat=True)(twin, batch)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    for x, y in zip(numpy_leaves(a.params), numpy_leaves(b.params)):
        np.testing.assert_array_equal(x, y)


def test_restart_from_checkpoint_resumes_training_exactly():
    """``tests/test_infra.py::test_checkpoint_restart_resumes_training`` on
    the port: 5 steps with a checkpoint at step 3 (a ``TrainState``
    template), restored and replayed: the same losses, exactly."""
    _, cfg = configs("yi-9b", "bfloat16")
    state = init_train_state(port_tree("yi-9b", "bfloat16"))
    step_fn = make_train_step(cfg)
    data = SyntheticLMData(cfg, batch=4, seq_len=16, seed=42, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        losses_a = []
        for s in range(5):
            if s == 3:
                mgr.save(state, step=s)
            state, m = step_fn(state, data.batch_at(s))
            losses_a.append(float(m["loss"]))
        restored, start = mgr.restore(state)
        assert isinstance(restored, TrainState) and start == 3
        state2 = train_state_from(restored, "cpu")
        assert state2.params["embed"].dtype == torch.bfloat16 and state2.opt.step.dtype == torch.int32
        losses_b = []
        for s in range(start, 5):
            state2, m = step_fn(state2, data.batch_at(s))
            losses_b.append(float(m["loss"]))
    assert losses_a[3:] == losses_b


def test_reference_checkpoint_trains_on_in_the_port():
    """A reference ``TrainState`` (float32 params, with error feedback)
    checkpointed after 2 steps by the reference, restored by the port with
    a template and trained on: the reference's next two losses at rtol
    1e-5; ``train_state_to_numpy`` gives the restored leaves back."""
    ref_cfg, cfg = configs("yi-9b", "float32")
    rs = ref_init_train_state(ref_tree("yi-9b"), compression=True)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, compression=True))
    ref_data = RefData(ref_cfg, B, S, seed=9)
    with tempfile.TemporaryDirectory() as d:
        losses = []
        for s in range(4):
            if s == 2:
                RefCheckpointManager(d).save(rs, step=s)
            rs, m = ref_step(rs, ref_data.batch_at(s))
            losses.append(float(m["loss"]))
        template = init_train_state(port_tree("yi-9b"), compression=True)
        restored, start = CheckpointManager(d).restore(template)
    assert start == 2
    state = train_state_from(restored, "cpu")
    back = train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, np.asarray(b))
    step = make_train_step(cfg, compression=True)
    data = SyntheticLMData(cfg, B, S, seed=9, device="cpu")
    got = []
    for s in range(start, 4):
        state, m = step(state, data.batch_at(s))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, losses[2:], rtol=1e-5)
    assert int(state.opt.step) == 4
