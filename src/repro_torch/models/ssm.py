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
from torch.distributed.tensor import DTensor, Partial, Shard

from .._device import make_generator, resolve_device
from .common import (
    FSDP_AXES,
    ModelConfig,
    axis_gather,
    axis_sum,
    constrain_batch,
    einsum,
    gathered,
    init_dense,
    init_zeros,
    mm,
    model_block,
    param_device,
    rmsnorm,
    silu,
    softplus,
    summed,
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


def _scan(x, Bm, Cm, dt, a, Q, N=None, total=None, whole=None):
    """The chunk loop: y (B, S, H, P) of x (B, S, H, P), Bm, Cm (B, S, N),
    dt and the log decay a (B, S, H), float32, the state carried from chunk
    to chunk.  On one chip's block of the heads and of the state
    (:func:`_ssd_local`), ``Bm`` and ``Cm`` hold the block of the state's
    ``N`` dims, ``total`` completes a partial sum over the state (the
    scores ``C Bᵀ``) and ``whole`` gathers a block of ``B`` or ``C`` whole
    over it for the products with the heads' state; both are the identity
    by default, and ``N`` is ``Bm`` 's last dim."""
    total = total or (lambda t: t)
    whole = whole or (lambda t: t)
    B, S, H, P = x.shape
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, -1)
    Cc = Cm.reshape(B, nc, Q, -1)
    dtc = dt.reshape(B, nc, Q, H)
    ac = a.reshape(B, nc, Q, H)

    h = torch.zeros((B, H, P, N or Bm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, aq = xc[:, c], Bc[:, c], Cc[:, c], dtc[:, c], ac[:, c]
        cum = _cumsum(aq, 1)  # (B,Q,H)
        # inter-chunk contribution: y_off[i] = C_i · (h * exp(cum_i))
        y_off = einsum("bqn,bhpn,bqh->bqhp", whole(Cq), h, torch.exp(cum))
        # intra-chunk (dual quadratic form)
        Lmat = torch.exp(_segsum(aq.transpose(1, 2)))  # (B,H,Q,Q)
        CB = total(einsum("bqn,bsn->bqs", Cq, Bq))  # (B,Q,Q)
        y_diag = einsum("bqs,bhqs,bsh,bshp->bqhp", CB, Lmat, dtq, xq)
        # state passed to the next chunk
        decay_tail = torch.exp(cum[:, -1:, :] - cum)  # (B,Q,H)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + einsum(
            "bqn,bqh,bqhp->bhpn", whole(Bq), dtq * decay_tail, xq
        )
        ys.append(y_off + y_diag)
    return torch.stack(ys, dim=1).reshape(B, S, H, P)


def ssd_forward(p, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  u: (B, S, D) -> (B, S, D).  S % chunk == 0.  On
    DTensors whose model axis divides the heads and the state, the SSD runs
    on each chip's block of both (:func:`_ssd_local`)."""
    H, P, N, d_inner, conv_dim = _dims(cfg)
    B, S, D = u.shape
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq len {S} must be divisible by ssm_chunk {Q}")
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    axis = _heads_axis(xbc, H, N)
    if axis is not None:
        y = _ssd_local(p, cfg, xbc, dt_raw, Q, axis).to(u.dtype)
    else:
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
        y = constrain_batch(_scan(x, Bm, Cm, dt, a, Q))
        y = y + x * p["D_skip"][None, None, :, None]
        y = constrain_batch(y.reshape(B, S, d_inner).to(u.dtype))
    # gated RMSNorm (mamba2 uses norm(y * silu(z)))
    y = y * silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return mm(y, p["w_out"])


def _heads_axis(t, H: int, N: int):
    """The mesh axis over which the SSD of the DTensor ``t`` runs on each
    chip's block of the heads and of the state: the one tensor-parallel axis
    (outside :data:`common.FSDP_AXES`) of size > 1, where it divides both
    ``H`` and ``N``; None on a plain tensor and where there is no such
    axis (the SSD then runs whole on each chip of it)."""
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    axes = [i for i, a in enumerate(names) if a not in FSDP_AXES and mesh.size(i) > 1]
    if len(axes) != 1 or H % mesh.size(axes[0]) or N % mesh.size(axes[0]):
        return None
    return axes[0]


class _Total(torch.autograd.Function):
    """A partial sum over the model axis completed there (an all-reduce),
    and its gradient too: each chip's consumers are its own heads, so each
    holds only its share of it."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return axis_sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return axis_sum(g, ctx.mesh, ctx.axis), None, None


class _Whole(torch.autograd.Function):
    """A chip's block along the last dim gathered whole over the model axis
    (an all-gather); backward, the gradient, each chip's heads' share of it,
    all-reduced, and the chip's block of it taken."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, t.shape[-1]
        return axis_gather(t, mesh, axis, -1)

    @staticmethod
    def backward(ctx, g):
        whole = axis_sum(g, ctx.mesh, ctx.axis)
        return whole.narrow(-1, ctx.mesh.get_local_rank(ctx.axis) * ctx.n, ctx.n), None, None


def _ssd_local(p, cfg: ModelConfig, xbc: DTensor, dt_raw: DTensor, Q: int, axis: int) -> DTensor:
    """The SSD between the projection and the gated norm on each chip's
    heads and state, as the reference's partitioner runs it: ``x``, ``dt``
    and the decay on the chip's block of the ``H`` heads, ``B`` and ``C``
    on its block of the ``N`` state dims, the causal conv on each piece's
    own columns (and ``conv_w`` 's), and the chunk loop on the local
    blocks (:func:`_scan`), each chunk's scores ``C Bᵀ`` all-reduced over
    the model axis (:class:`_Total`, its gradient too) and ``B`` and ``C``
    gathered whole over it for the products with the heads' state
    (:class:`_Whole`, the gradients all-reduced).  ``xbc`` and ``dt_raw``
    are whole on ``axis`` (the projection pinned to the batch axes): each
    piece is sliced to its block there (no collective; torch 2.11's
    DTensor refuses the strided views of a split across the projection's
    own column blocks) and run as local tensors.  Returns y (B, S,
    d_inner), float32, before the gated norm, sharded on its heads over
    ``axis``."""
    H, P, N, d_inner, conv_dim = _dims(cfg)
    mesh = xbc.device_mesh
    rows = list(xbc.placements)  # the batch on the data axes, whole on ``axis``

    def own(t, param=False):
        """The DTensor ``t`` (whole on ``axis``) as the chip's block of its
        last dim, a local tensor; a param's gradient there is each chip's
        share over the batch axes."""
        t = model_block(t, -1)
        grad = [Partial() if param and i != axis and r.is_shard() else q
                for i, (q, r) in enumerate(zip(t.placements, rows))]
        return t.to_local(grad_placements=grad)

    x_raw, B_raw, C_raw = torch.split(xbc, [d_inner, N, N], dim=-1)
    w_x, w_B, w_C = torch.split(gathered(p["conv_w"], -1), [d_inner, N, N], dim=-1)
    x, _ = _causal_conv(own(x_raw), own(w_x, True))
    Bm, _ = _causal_conv(own(B_raw), own(w_B, True))
    Cm, _ = _causal_conv(own(C_raw), own(w_C, True))
    Bl, S = x.shape[:2]
    x = x.reshape(Bl, S, -1, P).float()
    dt = softplus(own(dt_raw).float() + own(p["dt_bias"], True))
    a = dt * -torch.exp(own(p["A_log"], True))
    y = _scan(x, Bm.float(), Cm.float(), dt, a, Q, N, total=lambda t: _Total.apply(t, mesh, axis),
              whole=lambda t: _Whole.apply(t, mesh, axis))
    y = y + x * own(p["D_skip"], True)[None, None, :, None]
    y = y.reshape(Bl, S, -1)
    pl = list(rows)
    pl[axis] = Shard(2)
    shape = (xbc.shape[0], S, d_inner)
    return DTensor.from_local(y, mesh, pl, run_check=False, shape=shape, stride=(S * d_inner, d_inner, 1))


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
    """One token: u (B, 1, D) -> (B, 1, D), updated state.  O(1) in context.
    On DTensors the step runs on each chip's block of the state as it is
    laid out (:func:`_as_state`), and the gated norm on the (H, P) heads
    of that block (:func:`_gated_norm_heads`)."""
    H, P, N, d_inner, conv_dim = _dims(cfg)
    B = u.shape[0]
    z, xbc, dt_raw = _split_proj(p, cfg, u)
    xbc_act, new_tail = _causal_conv(xbc, p["conv_w"], tail=state.conv.to(xbc.dtype))
    xh, Bm, Cm = torch.split(xbc_act[:, 0], [d_inner, N, N], dim=-1)
    x = _as_state(xh.reshape(B, H, P).float(), state.h, (0, 1, 2))
    Bm = _as_state(Bm.float(), state.h, (0, 3))
    Cm = _as_state(Cm.float(), state.h, (0, 3))
    dt = _as_state(softplus(dt_raw[:, 0].float() + p["dt_bias"]), state.h, (0, 1))  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)  # (B,H)
    h = state.h * decay[:, :, None, None] + einsum("bn,bh,bhp->bhpn", Bm, dt, x)
    y = einsum("bn,bhpn->bhp", Cm, h) + x * p["D_skip"][None, :, None]
    if isinstance(y, DTensor):
        y = _gated_norm_heads(y.to(u.dtype)[:, None], z, p["norm"], cfg.norm_eps).reshape(B, 1, d_inner)
    else:
        y = y.reshape(B, 1, d_inner).to(u.dtype)
        y = y * silu(z)
        y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return mm(y, p["w_out"]), SSDState(h=h, conv=new_tail.float())


def _as_state(t: torch.Tensor, h: torch.Tensor, dims) -> torch.Tensor:
    """``t``, whose dims are the dims ``dims`` of the decode state ``h``
    (B, H, P, N), sliced to ``h`` 's block on each mesh axis where ``h``
    shards one of them and ``t`` is whole there (``Replicate`` -> ``Shard``:
    no collective), so that the step's products run on each chip's block of
    the state, as the reference's partitioner runs them on the state's
    layout.  The identity on plain tensors."""
    if not (isinstance(t, DTensor) and isinstance(h, DTensor)):
        return t
    pl = [Shard(dims.index(q.dim)) if p.is_replicate() and type(q) is Shard and q.dim in dims else p
          for p, q in zip(t.placements, h.placements)]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def _gated_norm_heads(y: DTensor, z: DTensor, gamma: DTensor, eps: float) -> DTensor:
    """The gated RMSNorm ``rmsnorm(y * silu(z), gamma)`` of a decode step's
    y (B, 1, H, P), laid out as the state's heads block, over its (H, P)
    dims: the mean's partial sums over a sharded H or P all-reduced where
    they are made (:func:`common.summed`), as the reference's partitioner
    all-reduces the gated norm's mean, where merging the heads into
    ``d_inner`` across their shard is a strided view that torch 2.11
    refuses.  Returns y (B, 1, H, P) whole on every chip."""
    y = y * silu(z.reshape(y.shape))
    dtype = y.dtype
    y = y.float()
    var = summed(torch.mean(y * y, dim=(-2, -1), keepdim=True))
    out = y * torch.rsqrt(var + eps)
    out = (out * (1.0 + gathered(gamma).reshape(y.shape[-2:]).float())).to(dtype)
    return gathered(gathered(out, -1), -2)
