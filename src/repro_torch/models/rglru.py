"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
counterpart of ``repro.models.rglru``.

    r_t = σ(W_a x_t + b_a)                     (recurrence gate)
    i_t = σ(W_x x_t + b_x)                     (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)          (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence path runs the linear recurrence as a log-depth scan
(:func:`associative_scan`) that follows ``jax.lax.associative_scan``'s
odd/even recursion, so each prefix is combined in the reference's order
and rounds as it does in float32.  Decode is a single-step update.  The
gates run in float32 against the weights, as the reference's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from .._device import make_generator, resolve_device
from .common import (ModelConfig, gathered, gelu_tanh, init_dense, laid_out_as, mm, model_block, param_device,
                     sigmoid, softplus, summed_grad)

__all__ = [
    "init_rglru_block",
    "rglru_forward",
    "rglru_decode_step",
    "RGLRUState",
    "init_rglru_state",
    "associative_scan",
]

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, W) recurrent state, float32
    conv: torch.Tensor  # (B, conv_width-1, W) conv tail, float32


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def init_rglru_block(key, cfg: ModelConfig, *, device=None):
    """Returns (params, specs) of one recurrent block; draws from ``key`` (a
    generator, or a seed for one on ``device``)."""
    gen = make_generator(key, device)
    W, D = _width(cfg), cfg.d_model
    dt = cfg.param_dtype
    dev = param_device(gen)
    params = {
        "w_gate_branch": init_dense(gen, (D, W), dt),
        "w_rec_branch": init_dense(gen, (D, W), dt),
        "conv_w": init_dense(gen, (cfg.conv_width, W), dt, scale=0.5),
        "w_a": init_dense(gen, (W, W), dt),
        "b_a": torch.full((W,), -1.0, dtype=torch.float32, device=dev),  # bias toward remembering
        "w_x": init_dense(gen, (W, W), dt),
        "b_x": torch.zeros((W,), dtype=torch.float32, device=dev),
        "lam": torch.full((W,), 0.7, dtype=torch.float32, device=dev),  # Λ (softplus -> decay rate)
        "w_out": init_dense(gen, (W, D), dt),
    }
    specs = {
        "w_gate_branch": ("embed", "ff"),
        "w_rec_branch": ("embed", "ff"),
        "conv_w": (None, "ff"),
        "w_a": ("ff", "ff2"),
        "b_a": ("ff",),
        "w_x": ("ff", "ff2"),
        "b_x": ("ff",),
        "lam": ("ff",),
        "w_out": ("ff", "embed"),
    }
    return params, specs


def _gates(p, x):
    """x: (..., W) post-conv activations -> (a_t, gated input), float32."""
    # each product's partial sums completed before its bias (``mm``): torch
    # 2.11 cannot add a bias sharded like the product's columns to them;
    # then sliced to the bias's columns (``model_block``), where 2.13 puts
    # the sum and 2.11 would gather the bias and run the gates whole
    r = sigmoid(model_block(mm(x.float(), p["w_a"].float()), -1) + p["b_a"])
    i = sigmoid(model_block(mm(x.float(), p["w_x"].float()), -1) + p["b_x"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, b


def _conv(x, conv_w, tail=None):
    Wd = conv_w.shape[0]
    pad = (
        torch.zeros((x.shape[0], Wd - 1, x.shape[2]), dtype=x.dtype, device=x.device)
        if tail is None
        else tail.to(x.dtype)
    )
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1]] * conv_w[i] for i in range(Wd))
    return out, xp[:, -(Wd - 1) :]


def associative_scan(fn: Callable, elems: Tuple[torch.Tensor, ...], dim: int = 0):
    """Inclusive scan of the associative ``fn`` over ``dim`` of each tensor
    in ``elems``, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the reduced sequence (the odd prefixes), combine
    each with the next even element, and interleave.  Depth log2 of the
    length; every prefix associates as in the reference."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems), tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0 b0 a1 b1 ... along ``dim`` (``a`` as long as ``b`` or one longer).
    DTensors interleave block by block, ``dim`` whole on every chip and
    ``b`` placed as ``a``: DTensor makes the ``new_empty`` buffer
    replicated, so each write into it would gather the whole batch."""
    if isinstance(a, DTensor):
        a = gathered(a, dim)
        mesh, pl = a.device_mesh, a.placements
        out = _interleave(a.to_local(), b.redistribute(mesh, pl).to_local(), dim)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def rglru_forward(p, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block.  u: (B, S, D)."""
    # column-parallel: each product's input gradient completed where it is made
    gate = gelu_tanh(mm(summed_grad(u), p["w_gate_branch"]))
    x, _ = _conv(mm(summed_grad(u), p["w_rec_branch"]), p["conv_w"])
    a, b = _gates(p, x)  # (B,S,W) f32
    _, h = associative_scan(_combine, (a, b), dim=1)
    y = h.to(u.dtype) * gate
    return mm(y, p["w_out"])


def init_rglru_state(cfg: ModelConfig, batch: int, *, device=None) -> RGLRUState:
    """Zero state on ``device`` (default ``"cuda"``; ``"meta"`` allocates
    nothing)."""
    dev = resolve_device(device)
    W = _width(cfg)
    return RGLRUState(
        h=torch.zeros((batch, W), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, cfg.conv_width - 1, W), dtype=torch.float32, device=dev),
    )


def rglru_decode_step(p, cfg: ModelConfig, u: torch.Tensor, state: RGLRUState):
    """One token: u (B, 1, D).  O(1) per token."""
    gate = gelu_tanh(mm(u, p["w_gate_branch"]))  # (B,1,W)
    x, new_tail = _conv(mm(u, p["w_rec_branch"]), p["conv_w"], tail=state.conv)
    a, b = _gates(p, x[:, 0])  # (B,W)
    h = a * laid_out_as(state.h, a) + b
    y = h[:, None, :].to(u.dtype) * gate
    return mm(y, p["w_out"]), RGLRUState(h=h, conv=new_tail.float())
