"""The port's serve-step factories (``repro_torch.train.servestep``)
against the reference's: ``make_serve_step`` gives the reference's greedy
tokens over 8 steps, and ``make_prefill_step`` its last-position logits.

Params come from the reference's ``init_params(PRNGKey(0), cfg)`` (shared
with ``tests/test_torch_transformer.py``).  The reference runs under
``jax.jit``, except the bfloat16 serve steps, which run op by op: a
greedy argmax compares logits whose top two can sit one bfloat16 ulp
apart, and op by op the reference rounds as eager torch does.  Tokens are
compared exactly; logits within 2e-5·max|ref| with float32 params and at
rtol 0.1 / atol 0.15 at bfloat16.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_decode_state as ref_init_decode_state
from repro.train.servestep import make_prefill_step as ref_make_prefill_step
from repro.train.servestep import make_serve_step as ref_make_serve_step
from repro_torch.models import init_decode_state
from repro_torch.train.servestep import make_prefill_step, make_serve_step
from test_torch_attention import DTYPES, assert_close
from test_torch_transformer import B, S, case, port_batch, ref_batch

ARCHS = ["qwen3-14b", "recurrentgemma-9b"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_greedy_tokens_match_reference(arch, dtype):
    """8 greedy steps from the first prompt token, each step's token fed to
    the next, from a fresh state; the tokens stay int32 on the device."""
    ref_cfg, cfg, rp, pp, batch = case(arch, dtype)
    ref_step = ref_make_serve_step(ref_cfg)
    op_by_op = dtype == "bfloat16"
    if not op_by_op:
        ref_step = jax.jit(ref_step)
    step = make_serve_step(cfg)
    rt = jnp.asarray(batch["tokens"][:, :1])
    pt = torch.from_numpy(batch["tokens"][:, :1])
    rs = ref_init_decode_state(ref_cfg, B, S, filled=False)
    ps = init_decode_state(cfg, B, S, filled=False, device="cpu")
    got, want = [], []
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        for _ in range(8):
            rt, rs = ref_step(rp, rt, rs)
            pt, ps = step(pp, pt, ps)
            assert pt.dtype == torch.int32 and tuple(pt.shape) == (B, 1)
            got.append(pt.numpy().copy())
            want.append(np.asarray(rt))
    assert int(ps.position) == 8
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))
    assert int(np.concatenate(got).max()) < cfg.vocab  # never a padded column


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch, dtype):
    ref_cfg, cfg, rp, pp, batch = case(arch, dtype)
    want = jax.jit(ref_make_prefill_step(ref_cfg))(rp, ref_batch(batch))
    got = make_prefill_step(cfg)(pp, port_batch(batch))
    assert tuple(got.shape) == (B, cfg.vocab_padded)
    assert_close(got, want, dtype)


def test_serve_step_argmax_ignores_padded_vocab():
    """Padded logit columns never win, even when they hold the maximum."""
    _, cfg, _, pp, batch = case("qwen3-14b", "float32")
    assert cfg.vocab_padded == cfg.vocab  # 512: no padding at smoke width
    cfg = cfg.scaled(vocab=cfg.vocab - 12)
    pp = dict(pp, lm_head=pp["lm_head"].clone())
    pp["lm_head"][:, cfg.vocab :] = 100.0
    tok, _ = make_serve_step(cfg)(pp, torch.from_numpy(batch["tokens"][:, :1]),
                                  init_decode_state(cfg, B, S, filled=False, device="cpu"))
    assert int(tok.max()) < cfg.vocab
