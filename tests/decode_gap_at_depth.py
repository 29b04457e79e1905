"""Decode vs forward at depth, in the reference and in the port, on the CPU.

``tests/test_arch_smoke.py`` holds token-by-token decode from a fresh state
to the full-sequence forward's last position at rtol 0.1 / atol 0.15, with
bfloat16 params, on two-layer SMOKE configs.  This script runs the same
comparison at a config's full depth (SMOKE width, so it stays small), in
the reference (``repro``) and in the port (``repro_torch``, ``device="cpu"``)
on the same params and tokens, and prints for each: max|d|, max|logits|,
the logits over the bound, and whether the argmax agrees.  It is the
witness for the bound that ``chip_smoke.py`` reports, and does not hold, at
full depth.

    PYTHONPATH=src python tests/decode_gap_at_depth.py [--arch mamba2-780m]
        [--layers N] [--prompt 32] [--seed 1]
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward
from repro.models import init_decode_state as ref_init_decode_state
from repro.models import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from
from repro_torch.models import decode_step, forward_train, init_decode_state


def report(name: str, step: np.ndarray, full: np.ndarray, vocab: int) -> None:
    diff = np.abs(step - full)
    over = int((diff > 0.15 + 0.1 * np.abs(full)).sum())
    agree = int(step[:vocab].argmax()) == int(full[:vocab].argmax())
    print(f"{name}: max|d| {diff.max():.4g}, max|logits| {np.abs(full).max():.4g}, "
          f"{over} of {diff.size} logits over rtol 0.1 / atol 0.15, argmax agrees {agree}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the full config's)")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    layers = args.layers or ref_get_config(args.arch).n_layers
    ref_cfg = ref_get_config(args.arch, smoke=True).scaled(n_layers=layers)
    cfg = get_config(args.arch, smoke=True).scaled(n_layers=layers)
    rp, _ = ref_init_params(jax.random.PRNGKey(args.seed), ref_cfg)
    pp = params_from(jax.tree.map(np.asarray, rp), "cpu")
    S = args.prompt
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, S)).astype(np.int32)
    print(f"{args.arch}: SMOKE width D {cfg.d_model}, {layers} layers, {S}-token prompt, "
          f"{cfg.param_dtype} params")

    full, _ = jax.jit(lambda p, t: ref_forward(p, ref_cfg, {"tokens": t}))(rp, jnp.asarray(tokens))
    step_fn = jax.jit(lambda p, t, s: ref_decode_step(p, ref_cfg, t, s))
    st = ref_init_decode_state(ref_cfg, batch=1, seq_len=S, filled=False)
    for i in range(S):
        logits, st = step_fn(rp, jnp.asarray(tokens[:, i : i + 1]), st)
    report("reference", np.asarray(logits[0, 0], np.float32), np.asarray(full[0, -1], np.float32),
           cfg.vocab)

    t = torch.from_numpy(tokens)
    with torch.no_grad():
        full_p, _ = forward_train(pp, cfg, {"tokens": t})
        st_p = init_decode_state(cfg, 1, S, filled=False, device="cpu")
        for i in range(S):
            logits_p, st_p = decode_step(pp, cfg, t[:, i : i + 1], st_p)
    report("port", logits_p[0, 0].float().numpy(), full_p[0, -1].float().numpy(), cfg.vocab)


if __name__ == "__main__":
    main()
