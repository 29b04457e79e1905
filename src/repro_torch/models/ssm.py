"""Mamba-2 SSD (state-space duality) block, chunked scan formulation
(counterpart of ``repro.models.ssm``).

Follows the minimal SSD algorithm of Dao & Gu (arXiv:2405.21060): the
sequence is split into chunks; within a chunk the quadratic
(attention-dual) form runs as products, between chunks a small recurrent
state (B, heads, head_dim, state) is carried in float32 by a host loop over
the chunks (the reference's ``lax.scan``).  Single-step decode updates the
state directly (O(1) per token).  Every float32 cast of the reference is
kept, so bfloat16 weights meet a float32 scan as they do there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .._device import make_generator, resolve_device
from .common import (
    ModelConfig,
    constrain_batch,
    einsum,
    gathered,
    init_dense,
    init_zeros,
    mm,
    param_device,
    rmsnorm,
    silu,
    softplus,
    summed_grad,
)

__all__ = ["init_ssd", "ssd_forward", "ssd_decode_step", "SSDState", "init_ssd_state"]


class SSDState(NamedTuple):
    h: torch.Tensor  # (B, H, P, N) inter-chunk state, float32
    conv: torch.Tensor  # (B, W-1, conv_dim) causal-conv tail, float32


def _dims(cfg: ModelConfig):
    H = cfg.ssm_heads or max(1, (2 * cfg.d_model) // cfg.ssm_head_dim)
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    d_inner = H * P
    conv_dim = d_inner + 2 * N  # conv over [x, B, C]
    return H, P, N, d_inner, conv_dim


def init_ssd(key, cfg: ModelConfig, *, device=None):
    """Returns (params, specs) of one SSD block; draws from ``key`` (a
    generator, or a seed for one on ``device``)."""
    gen = make_generator(key, device)
    H, P, N, d_inner, conv_dim = _dims(cfg)
    D = cfg.d_model
    dt = cfg.param_dtype
    a_log = torch.from_numpy(np.log(np.arange(1, H + 1, dtype=np.float32))).to(param_device(gen))
    params = {
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "w_in": init_dense(gen, (D, 2 * d_inner + 2 * N + H), dt),
        "conv_w": init_dense(gen, (cfg.conv_width, conv_dim), dt, scale=0.5),
        "A_log": a_log,
        "dt_bias": init_zeros(gen, (H,), torch.float32),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=param_device(gen)),
        "norm": init_zeros(gen, (d_inner,), dt),
        "w_out": init_dense(gen, (d_inner, D), dt),
    }
    specs = {
        "w_in": ("embed", "ff"),
        "conv_w": (None, "ff"),
        "A_log": (None,),
        "dt_bias": (None,),
        "D_skip": (None,),
        "norm": ("ff",),
        "w_out": ("ff", "embed"),
    }
    return params, specs


def _split_proj(p, cfg, x):
    H, P, N, d_inner, conv_dim = _dims(cfg)
    # pinned to the batch axes, its gradient too: split into z, x, B, C and
    # dt across its model-axis shard, and the heads split out of those, the
    # backward's views are strided shardings that DTensor plans by graph
    # search (and torch 2.11 refuses); column-parallel, its input gradient
    # completed where it is made
    proj = constrain_batch(mm(summed_grad(x), p["w_in"]))
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv_w, tail=None):
    """Depthwise causal conv, width W.  xbc: (B,S,Cd).  tail: (B,W-1,Cd)."""
    W = conv_w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i : i + xbc.shape[1]] * conv_w[i] for i in range(W))
    return silu(out), xp[:, -(W - 1) :]


class _BlockCumsum(torch.autograd.Function):
    """``torch.cumsum`` of a DTensor whose backward runs autograd's own
    formula (the gradient flipped, summed, flipped back) on each chip's
    block, ``dim`` whole on every chip: torch 2.11's DTensor has no
    strategy for ``flip``."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, g):
        g = gathered(g, ctx.dim)
        block = g.to_local().flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim)
        return DTensor.from_local(block, g.device_mesh, g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride()), None


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; on a DTensor through :class:`_BlockCumsum`."""
    return _BlockCumsum.apply(x, dim % x.ndim) if isinstance(x, DTensor) else torch.cumsum(x, dim)


def _segsum(a):
    """log-decay matrix L[i,j] = Σ_{k=j+1..i} a_k (j<=i), -inf above diag.
    a: (..., L)."""
    Lc = a.shape[-1]
    cums = _cumsum(a, -1)
    diff = cums[..., :, None] - cums[..., None, :]  # (..., i, j) = sum(j+1..i)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_forward(p, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  u: (B, S, D) -> (B, S, D).  S % chunk == 0."""
    H, P, N, d_inner, conv_dim = _dims(cfg)
    B, S, D = u.shape
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq len {S} must be divisible by ssm_chunk {Q}")
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    xbc, _ = _causal_conv(xbc, p["conv_w"])
    xh, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    # x and y pinned like the projection, so that the backward's gradients
    # reach the head splits and merges whole on the model axis
    x = constrain_batch(xh.reshape(B, S, H, P).float())
    Bm = Bm.reshape(B, S, N).float()
    Cm = Cm.reshape(B, S, N).float()
    dt = softplus(dt_raw.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)
    a = dt * A  # (B,S,H) log decay

    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    ac = a.reshape(B, nc, Q, H)

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, aq = xc[:, c], Bc[:, c], Cc[:, c], dtc[:, c], ac[:, c]
        cum = _cumsum(aq, 1)  # (B,Q,H)
        # inter-chunk contribution: y_off[i] = C_i · (h * exp(cum_i))
        y_off = einsum("bqn,bhpn,bqh->bqhp", Cq, h, torch.exp(cum))
        # intra-chunk (dual quadratic form)
        Lmat = torch.exp(_segsum(aq.transpose(1, 2)))  # (B,H,Q,Q)
        CB = einsum("bqn,bsn->bqs", Cq, Bq)  # (B,Q,Q)
        y_diag = einsum("bqs,bhqs,bsh,bshp->bqhp", CB, Lmat, dtq, xq)
        # state passed to the next chunk
        decay_tail = torch.exp(cum[:, -1:, :] - cum)  # (B,Q,H)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + einsum(
            "bqn,bqh,bqhp->bhpn", Bq, dtq * decay_tail, xq
        )
        ys.append(y_off + y_diag)
    y = constrain_batch(torch.stack(ys, dim=1).reshape(B, S, H, P))
    y = y + x * p["D_skip"][None, None, :, None]
    y = constrain_batch(y.reshape(B, S, d_inner).to(u.dtype))
    # gated RMSNorm (mamba2 uses norm(y * silu(z)))
    y = y * silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return mm(y, p["w_out"])


def init_ssd_state(cfg: ModelConfig, batch: int, *, device=None) -> SSDState:
    """Zero state on ``device`` (default ``"cuda"``; ``"meta"`` allocates
    nothing)."""
    dev = resolve_device(device)
    H, P, N, d_inner, conv_dim = _dims(cfg)
    return SSDState(
        h=torch.zeros((batch, H, P, N), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=torch.float32, device=dev),
    )


def ssd_decode_step(p, cfg: ModelConfig, u: torch.Tensor, state: SSDState):
    """One token: u (B, 1, D) -> (B, 1, D), updated state.  O(1) in context."""
    H, P, N, d_inner, conv_dim = _dims(cfg)
    B = u.shape[0]
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    xbc_act, new_tail = _causal_conv(xbc, p["conv_w"], tail=state.conv.to(xbc.dtype))
    xh, Bm, Cm = torch.split(xbc_act[:, 0], [d_inner, N, N], dim=-1)
    x = xh.reshape(B, H, P).float()
    Bm = Bm.float()
    Cm = Cm.float()
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)  # (B,H)
    h = state.h * decay[:, :, None, None] + einsum("bn,bh,bhp->bhpn", Bm, dt, x)
    y = einsum("bn,bhpn->bhp", Cm, h) + x * p["D_skip"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(u.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return mm(y, p["w_out"]), SSDState(h=h, conv=new_tail.float())
