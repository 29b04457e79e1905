"""Grouped-query attention with RoPE, qk-norm, QKV bias, sliding-window /
chunked masking, KV caches (full + ring-buffer) and cross-attention
(counterpart of ``repro.models.attention``).

Every cast of the reference stays where it is: the ``q·k`` product runs in
the inputs' dtype and only then goes to float32, and the probabilities go
back to ``v``'s dtype before the second product (``_sdpa``, and per tile in
``_flash_sdpa``).  Masked scores are ``NEG_INF = -1e30``, not ``-inf``, so
a row with every key masked gives the reference's uniform softmax.

The decode path writes the new token's K/V into the cache **in place** at a
device index (``index_copy_``): no functional copy of the cache, and no
read of the cache length on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .._device import make_generator, resolve_device
from .common import (
    FSDP_AXES,
    ModelConfig,
    apply_rope,
    axis_gather,
    axis_sum,
    constrain_batch,
    einsum,
    even_heads,
    gathered,
    init_dense,
    init_zeros,
    local_block,
    mm,
    model_block,
    rmsnorm,
    row_block,
    split_axis,
    split_last,
    summed,
    summed_grad,
    whole_grad,
)

__all__ = ["init_attention", "attention", "decode_attention", "KVCache", "init_kv_cache"]

NEG_INF = -1e30


def init_attention(key, cfg: ModelConfig, cross: bool = False, *, device=None):
    """Returns (params, specs) for one attention block; draws from ``key``
    (a generator, or a seed for one on ``device``)."""
    gen = make_generator(key, device)
    hd, H, K, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    dt = cfg.param_dtype
    params = {
        "wq": init_dense(gen, (D, H * hd), dt),
        "wk": init_dense(gen, (D, K * hd), dt),
        "wv": init_dense(gen, (D, K * hd), dt),
        "wo": init_dense(gen, (H * hd, D), dt),
    }
    specs = {
        "wq": ("embed", "heads_x_hd"),
        "wk": ("embed", "kv_x_hd"),
        "wv": ("embed", "kv_x_hd"),
        "wo": ("heads_x_hd", "embed"),
    }
    if cfg.qkv_bias and not cross:
        params.update(
            bq=init_zeros(gen, (H * hd,), dt), bk=init_zeros(gen, (K * hd,), dt),
            bv=init_zeros(gen, (K * hd,), dt),
        )
        specs.update(bq=("heads_x_hd",), bk=("kv_x_hd",), bv=("kv_x_hd",))
    if cfg.qk_norm:
        params.update(q_norm=init_zeros(gen, (hd,), dt), k_norm=init_zeros(gen, (hd,), dt))
        specs.update(q_norm=(None,), k_norm=(None,))
    return params, specs


def _project_qkv(p, cfg: ModelConfig, x, x_kv):
    hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    # column-parallel: each product's input gradient completed where it is made
    q = mm(summed_grad(x), p["wq"])
    k = mm(summed_grad(x_kv), p["wk"])
    v = mm(summed_grad(x_kv), p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = split_last(q, H, hd), split_last(k, K, hd), split_last(v, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _mask(
    sq: int,
    skv: int,
    q_offset,
    causal: bool,
    window: Optional[int],
    chunk: Optional[int],
    device=None,
):
    """(sq, skv) boolean mask; True = attend.  Query i has absolute position
    q_offset + i; key j has absolute position j."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= qpos - kpos < window
    if chunk is not None:
        m &= (qpos // chunk) == (kpos // chunk)
    return m


def _probs(q, k, mask):
    """The softmax of the masked, scaled scores, (B, K, G, S, T) in float32:
    q (B, S, K, G, hd), k (B, T, K, hd), mask (S, T) or (B, S, T)."""
    scores = einsum("bskgh,btkh->bkgst", q, k).float()
    # jnp.sqrt(hd) is a float32 sqrt; a float64 sqrt rounds to the same float32
    scores = scores / float(np.float32(np.sqrt(q.shape[-1])))
    if mask.ndim == 2:
        mask_b = mask[None, None, None]
    else:
        mask_b = mask[:, None, None]
    scores = torch.where(mask_b, scores, NEG_INF)
    return _softmax(scores)


def _sdpa(q, k, v, mask):
    """q: (B,S,H,hd)  k/v: (B,T,K,hd)  mask: (S,T) or (B,S,T).  GQA grouped.
    Where the KV heads are whole on each chip of a model axis, each chip
    runs its share of the heads (:func:`_head_groups`)."""
    groups = _head_groups(q, k, v)
    if groups is not None:
        mask = _whole(mask)
        return groups.attend(q, k, v, lambda q, k, v: _sdpa(q, k, v, mask), lambda q, k: _probs(q, k, mask))
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = even_heads(q, 2, K).reshape(B, S, K, G, hd)
    probs = _probs(q, k, mask).to(v.dtype)
    out = einsum("bkgst,btkh->bskgh", probs, v)
    return whole_grad(out.reshape(B, S, H, hd), 2)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole as a local tensor; a plain tensor itself."""
    return gathered(t).to_local() if isinstance(t, DTensor) else t


class _HeadGroups(NamedTuple):
    """Which heads of attention each chip of the model axis runs, as the
    reference's partitioner splits them, where k and v reach attention
    whole on each chip of that axis (replicated: pinned to the batch axes,
    or their heads gathered because the axis does not divide them).  With
    M chips on the axis, K KV heads and G query heads in each KV head's
    group:

    * K divisible by M: each chip its K/M KV heads and their groups;
    * M divisible by K, ``r`` = M/K chips to a KV head: when G is
      divisible by r, each chip its KV head and its G/r heads of the
      group, the KV's gradients summed over the r chips (qwen2-vl's 2 KV
      heads on a model axis of 4: an all-reduce over each pair); when r is
      divisible by G (2 KV heads on 8 chips), each chip its group's query
      head ``g`` and its block ``b`` of the head dim for the probabilities
      times v, the KV's gradients summed over the group's G heads; else
      each chip its whole group (10 heads and 2 KV heads on 4 chips: 5 on
      each chip of a pair), nothing summed;
    * else (phi3's 10 KV heads on 16 chips) None: the reference's
      partitioner runs such attention whole on each chip, and so does the
      port.

    ``mesh`` and ``axis``: the model axis; ``heads`` and ``kv``: the chip's
    query and KV heads, (first, count); ``sums``: the ``(mesh, axis)``
    groups the KV's gradients are summed over, the axis split into its
    parts (:func:`common.split_axis`); ``gathers``: the ``(mesh, axis,
    dim)`` groups that gather the KV's gradients whole; ``q_gathers``:
    those that gather q's gradient whole, None where the chip's heads are
    q's block over the axis (:func:`common.model_block`, its output laid
    out so); ``block``: ``(first, count)`` of the head dim's block, with
    the ``(mesh, axis, dim)`` groups that gather the gradient of v's block
    after ``sums``."""

    mesh: Any
    axis: int
    heads: Tuple[int, int]
    kv: Tuple[int, int]
    sums: Sequence
    gathers: Sequence
    q_gathers: Optional[Sequence]
    block: Optional[Tuple[Tuple[int, int], Sequence]] = None

    def attend(self, q: DTensor, k: DTensor, v: DTensor, attend, probs) -> DTensor:
        """``attend`` (plain attention of local tensors) on the chip's heads,
        or, with a ``block``, ``probs`` (the probabilities of local
        tensors) times v's block; (B, S, H, hd) laid out as q: its heads'
        block, else whole."""
        kl = _Take.apply(k.to_local(), ((2, *self.kv),), self.sums, self.gathers)
        if self.q_gathers is None:
            qb = model_block(q, 2)
            out = attend(qb.to_local(), kl, _Take.apply(v.to_local(), ((2, *self.kv),), self.sums, self.gathers))
            return _from_local(out, qb)
        ql = _Take.apply(q.to_local(), ((2, *self.heads),), (), self.q_gathers)
        if self.block is None:
            vl = _Take.apply(v.to_local(), ((2, *self.kv),), self.sums, self.gathers)
            out = _Gather.apply(attend(ql, kl, vl), self.gathers, 2)
        else:
            (first, n), v_gathers = self.block
            vb = _Take.apply(v.to_local(), ((2, *self.kv), (3, first, n)), self.sums, v_gathers)
            B, S, _, hd = ql.shape
            p = probs(ql.reshape(B, S, 1, 1, hd), kl).to(v.dtype)
            whole_v = v.to_local().detach().narrow(2, *self.kv)
            out = _HeadBlock.apply(p, vb, whole_v, self.mesh, self.axis, self.heads[0], first)
        return _from_local(out, q)


def _from_local(out: torch.Tensor, like: DTensor) -> DTensor:
    """A local (B, S, H, hd) block as a DTensor placed as ``like``."""
    B, S, H, hd = like.shape
    return DTensor.from_local(out, like.device_mesh, like.placements, run_check=False, shape=like.shape,
                              stride=(S * H * hd, H * hd, hd, 1))


def _head_groups(q, k, v, flash: bool = False) -> Optional[_HeadGroups]:
    """The chip's share of attention's heads (:class:`_HeadGroups`) where q,
    k and v are DTensors whose KV heads are whole on each chip of one model
    axis; None where they are not (plain tensors, a cache split on its
    slots or head dim), or where the reference's partitioner runs such
    heads whole; ``flash``: the flash path, which splits no head dim."""
    if not all(isinstance(t, DTensor) for t in (q, k, v)) or k.placements != v.placements or \
            any(p.is_shard(d) for p in k.placements for d in (1, 2, 3)) or \
            any(p.is_shard(d) for p in q.placements for d in (1, 3)):
        return None
    mesh = k.device_mesh
    names = mesh.mesh_dim_names or ()
    tp = [i for i, a in enumerate(names) if a not in FSDP_AXES and mesh.size(i) > 1]
    if len(tp) != 1 or any(a != b for i, (a, b) in enumerate(zip(q.placements, k.placements)) if i != tp[0]):
        return None
    axis = tp[0]
    M, H, K = mesh.size(axis), q.shape[2], k.shape[2]
    G, m = H // K, mesh.get_local_rank(axis)
    if K % M == 0:
        n = K // M
        return _HeadGroups(mesh, axis, (m * H // M, H // M), (m * n, n), (), ((mesh, axis, 2),), None)
    if M % K:
        return None
    r = M // K
    kh, j = divmod(m, r)
    if G % r == 0:
        if K == 1:
            return _HeadGroups(mesh, axis, (m * G // r, G // r), (0, 1), ((mesh, axis),), (), None)
        sub = split_axis(mesh, axis, (K, r))
        return _HeadGroups(mesh, axis, (m * G // r, G // r), (kh, 1), ((sub, axis + 1),), ((sub, axis, 2),), None)
    if not q.placements[axis].is_replicate() or K == 1 and r % G:
        return None
    if r % G:
        sub = split_axis(mesh, axis, (K, r))
        gathers = ((sub, axis, 2),)
        return _HeadGroups(mesh, axis, (kh * G, G), (kh, 1), (), gathers, gathers)
    if flash:
        return None
    c = r // G
    g, b = divmod(j, c)
    hd = k.shape[3]
    sub = split_axis(mesh, axis, (K, G, c))
    gathers = ((sub, axis, 2),) if K > 1 else ()
    return _HeadGroups(mesh, axis, (kh * G + g, 1), (kh, 1), ((sub, axis + 1),), gathers,
                       ((sub, axis + 1, 2), *gathers), ((b * hd // c, hd // c), ((sub, axis + 2, 3), *gathers)))


class _Take(torch.autograd.Function):
    """A local tensor's block (``narrows``: ``(dim, first, count)`` each);
    backward, the block's gradient summed over ``sums`` (the chips that
    hold the same block for other query heads), then gathered whole over
    ``gathers`` (the innermost first), the same on every chip."""

    @staticmethod
    def forward(ctx, x, narrows, sums, gathers):
        ctx.sums, ctx.gathers = sums, gathers
        for dim, first, n in narrows:
            x = x.narrow(dim, first, n)
        return x

    @staticmethod
    def backward(ctx, g):
        for mesh, axis in ctx.sums:
            g = axis_sum(g.contiguous(), mesh, axis)
        for mesh, axis, dim in ctx.gathers:
            g = axis_gather(g.contiguous(), mesh, axis, dim)
        return g, None, None, None


class _Gather(torch.autograd.Function):
    """Each chip's block gathered along ``dim`` over ``gathers`` (the
    innermost first); backward, the chip's block of the gradient, which is
    whole on every chip."""

    @staticmethod
    def forward(ctx, t, gathers, dim):
        ctx.dim, ctx.n, first = dim, t.shape[dim], 0
        for mesh, axis, d in gathers:
            t = axis_gather(t.contiguous(), mesh, axis, d)
        for mesh, axis, _ in reversed(gathers):
            first = first * mesh.size(axis) + mesh.get_local_rank(axis)
        ctx.first = first * ctx.n
        return t

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.first, ctx.n), None, None


class _HeadBlock(torch.autograd.Function):
    """A chip's query head ``head`` times its block of v's head dim (the
    probabilities (B, 1, 1, S, T) times ``vb`` (B, T, 1, hd / c)), gathered
    over the model axis into the heads (B, S, H, hd), whole on every chip
    (the chips' blocks are the merged heads' in order); backward, from the
    whole gradient the head's: the probabilities' gradient against the
    whole KV head ``v`` (B, T, 1, hd), v's block's against the block."""

    @staticmethod
    def forward(ctx, probs, vb, v, mesh, axis, head, first):
        ctx.save_for_backward(probs, v)
        ctx.head, ctx.first, ctx.n = head, first, vb.shape[-1]
        B, S = probs.shape[0], probs.shape[3]
        out = torch.einsum("bkgst,btkh->bskgh", probs, vb).reshape(B, S, -1)
        out = axis_gather(out, mesh, axis, -1)
        return out.view(B, S, -1, v.shape[-1])

    @staticmethod
    def backward(ctx, g):
        probs, v = ctx.saved_tensors
        dout = g[:, :, ctx.head, None, None]  # (B, S, 1, 1, hd)
        dprobs = torch.einsum("bskgh,btkh->bkgst", dout, v)
        dvb = torch.einsum("bkgst,bskgh->btkh", probs, dout.narrow(-1, ctx.first, ctx.n))
        return dprobs, dvb, None, None, None, None, None


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """``torch.softmax(scores, -1)``; on a DTensor whose keys (the last
    dim) are sharded, a decode cache split over its slots, the max and the
    sum of the exponentials are each chip's partial results, all-reduced
    (:func:`common.summed`), as the reference's partitioner runs the
    softmax over a split cache, where DTensor would gather the scores
    whole."""
    if not (isinstance(scores, DTensor) and any(p.is_shard(scores.ndim - 1) for p in scores.placements)):
        return torch.softmax(scores, dim=-1)
    e = torch.exp(scores - summed(scores.amax(-1, keepdim=True)))
    return e / summed(e.sum(-1, keepdim=True))


#: sequences at/above this length use the memory-bounded flash path
FLASH_THRESHOLD = 8192
FLASH_Q_BLOCK = 512
FLASH_KV_BLOCK = 1024


def _flash_sdpa(
    q,
    k,
    v,
    *,
    causal: bool,
    window: Optional[int],
    chunk: Optional[int],
    q_block: int = FLASH_Q_BLOCK,
    kv_block: int = FLASH_KV_BLOCK,
):
    """Online-softmax blocked attention: a host loop over query blocks, and
    within each a loop over the KV blocks it can reach.  Peak memory is one
    (B, K, G, q_block, kv_block) score tile instead of (B, H, S, T).

    For windowed (SWA) and chunked attention the KV loop is restricted to
    the blocks a query block can reach, as the reference's: ``first`` is a
    host int (the loop index is one), so the restriction costs no sync.
    Plain causal attention still visits every block (mask only)."""
    groups = _head_groups(q, k, v, flash=True)
    if groups is not None:
        return groups.attend(q, k, v, lambda q, k, v: _flash_sdpa(
            q, k, v, causal=causal, window=window, chunk=chunk, q_block=q_block, kv_block=kv_block), None)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q_block = min(q_block, S)
    kv_block = min(kv_block, T)
    if S % q_block or T % kv_block:
        raise ValueError(f"flash blocks must tile the sequence: {S}%{q_block}, {T}%{kv_block}")
    nq, nk = S // q_block, T // kv_block
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    dev = q.device

    # reachable KV-block count per query block (static)
    reach = None
    if window is not None:
        reach = window
    if chunk is not None:
        reach = chunk if reach is None else min(reach, chunk)
    if reach is not None:
        n_kv_needed = min(nk, (reach + q_block) // kv_block + 1)
    else:
        n_kv_needed = nk
    q_ar = torch.arange(q_block, device=dev)[:, None]
    k_ar = torch.arange(kv_block, device=dev)[None, :]

    def mask_block(qi, kpos_base):
        qpos = qi * q_block + q_ar
        kpos = kpos_base + k_ar
        m = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= qpos - kpos < window
        if chunk is not None:
            m &= (qpos // chunk) == (kpos // chunk)
        return m

    # buffers made *like* q and its tiles, so a DTensor q gives them its
    # batch sharding (a plain tensor gives the same buffers as torch.empty)
    dense = torch.contiguous_format
    out = torch.empty_like(q, memory_format=dense).view(B, S, K, G, hd)
    for qi in range(nq):
        qtile = q[:, qi * q_block : (qi + 1) * q_block].reshape(B, q_block, K, G, hd)
        if reach is not None:
            # first reachable KV block for the oldest query in this block
            first = min(max((qi * q_block - (reach - 1)) // kv_block, 0), nk - n_kv_needed)
            blocks = range(first, first + n_kv_needed)
        else:
            blocks = range(nk)
        rows = qtile.permute(0, 2, 3, 1, 4)  # (B, K, G, q_block, hd)
        m_run = torch.full_like(rows[..., 0], NEG_INF, dtype=torch.float32, memory_format=dense)
        l_run = torch.zeros_like(rows[..., 0], dtype=torch.float32, memory_format=dense)
        acc = torch.zeros_like(rows, dtype=torch.float32, memory_format=dense)
        for kj in blocks:
            ktile = k[:, kj * kv_block : (kj + 1) * kv_block]
            vtile = v[:, kj * kv_block : (kj + 1) * kv_block]
            s = einsum("bqkgh,btkh->bkgqt", qtile, ktile).float() * scale
            s = torch.where(mask_block(qi, kj * kv_block)[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            corr = torch.exp(m_run - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l_run = l_run * corr + p_.sum(-1)
            acc = acc * corr[..., None] + einsum(
                "bkgqt,btkh->bkgqh", p_.to(vtile.dtype), vtile
            ).float()
            m_run = m_new
        blk = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,K,G,q_block,hd)
        out[:, qi * q_block : (qi + 1) * q_block] = blk.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, S, H, hd)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The heads merged (:func:`_merge_heads`) times ``wo``, row-parallel:
    each chip multiplies its block of the merged heads by its rows of
    ``wo`` (:func:`common.row_block`), and ``mm`` sums the partial
    products, whether or not the heads divide the model axis (40 heads
    over 16 chips: ``wo`` 's 5,120 rows do), as the reference's
    partitioner slices the activation."""
    return mm(row_block(_merge_heads(out), wo), wo)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H·hd), pinned to the batch axes on both sides
    of the merge, as q, k and v are (an identity on plain tensors).  Left
    to DTensor, a head dim sharded inside the heads (a cross-attention
    cache's hd) or a gradient sharded over the merged heads would have to
    be merged or split across its shard: torch 2.11 refuses that, and 2.13
    makes a strided sharding that it then plans by graph search.  Where
    there is no data axis to pin to, a head dim sharded inside the heads
    (a decode cache whose widest dim is hd) is gathered first."""
    return constrain_batch(gathered(constrain_batch(out), -1).reshape(*out.shape[:2], -1))


def attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S) absolute positions
    *,
    causal: bool = True,
    x_kv: Optional[torch.Tensor] = None,  # cross-attention source
    kv_positions: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    force_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill)."""
    cross = x_kv is not None
    x_kv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(p, cfg, x, x_kv)
    if use_rope and not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions if kv_positions is not None else positions, cfg.rope_theta)
    q, k, v = constrain_batch(q), constrain_batch(k), constrain_batch(v)
    use_flash = (x_kv.shape[1] >= FLASH_THRESHOLD) if force_flash is None else force_flash
    if use_flash and not cross:
        out = _flash_sdpa(
            q, k, v, causal=causal, window=cfg.sliding_window, chunk=cfg.attn_chunk
        )
    else:
        if cross:
            mask = torch.ones((x.shape[1], x_kv.shape[1]), dtype=torch.bool, device=x.device)
        else:
            mask = _mask(x.shape[1], x_kv.shape[1], 0, causal, cfg.sliding_window,
                         cfg.attn_chunk, device=x.device)
        out = _sdpa(q, k, v, mask)
    return _out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# decode path (single-token) with KV caches
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, K, hd) — T = min(seq_len, window or chunk)
    v: torch.Tensor
    length: torch.Tensor  # 0-d int32 on the cache's device: absolute tokens seen so far

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
                  filled: bool = True, *, device=None):
    """Cache sized to the attention reach: full for global attention, ring of
    `window` (SWA) or `chunk` (chunked) otherwise.  `filled=True` builds the
    decode-benchmark state: a cache holding seq_len prior tokens (zeros,
    with ``length = seq_len``).  Built on ``device`` (default ``"cuda"``;
    ``"meta"`` allocates nothing)."""
    dev = resolve_device(device)
    reach = seq_len
    if cfg.sliding_window is not None:
        reach = min(reach, cfg.sliding_window)
    if cfg.attn_chunk is not None:
        reach = min(reach, cfg.attn_chunk)
    shape = (batch, reach, cfg.n_kv_heads, cfg.hd)
    length = torch.full((), seq_len if filled else 0, dtype=torch.int32, device=dev)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=length)


def _write_slot_(cache: torch.Tensor, idx: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, idx] = new`` in place, ``idx`` a (1,) index on the device.
    DTensor has no in-place ``index_copy_`` at an index into a sharded dim,
    so a DTensor cache is written block by block: ``new`` is laid out as
    the cache's blocks (replicated along the slot dim), and the chip whose
    block holds the slot writes it while every other chip writes back the
    entry it holds."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, idx, new)
        return
    block, first, (src,) = local_block(cache, 1, new)
    n = block.shape[1]
    local = idx.full_tensor() - first
    pos = local.clamp(0, n - 1)
    mine = ((local >= 0) & (local < n)).reshape(1, 1, 1, 1)
    block.index_copy_(1, pos, torch.where(mine, src, block.index_select(1, pos)))


def decode_attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D) current token
    cache: KVCache,
    *,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # encoder K/V
    use_rope: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: write the token's K/V into the (ring) cache and
    attend.  The write is in place: the returned cache holds the same
    ``k``/``v`` tensors as ``cache`` (now updated) and a new ``length``."""
    if cross_kv is not None:
        k_all, v_all = cross_kv
        B = x.shape[0]
        q = split_last(mm(x, p["wq"]), cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        q = constrain_batch(q)
        mask = torch.ones((1, k_all.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k_all, v_all, mask)
        return _out_proj(out, p["wo"]), cache

    B = x.shape[0]
    pos = cache.length  # 0-d absolute position of the new token (on the device)
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if use_rope:
        posb = pos.reshape(1, 1).expand(B, 1)
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    # the query pinned to the batch axes as the full-sequence path pins it:
    # with its heads sharded as well, the product's flattened batch dim is a
    # strided sharding, whose every candidate layout DTensor plans by graph
    # search (minutes on a pod mesh)
    q = constrain_batch(q)

    T = cache.capacity
    slot = pos % T  # ring-buffer slot (== pos for full caches until wrap)
    idx = slot.reshape(1).long()
    _write_slot_(cache.k, idx, k_new.to(cache.k.dtype))
    _write_slot_(cache.v, idx, v_new.to(cache.v.dtype))

    # absolute position of each slot's entry (RoPE was applied at write time):
    # slot s holds the most recent token with position ≡ s (mod T)
    slot_ids = torch.arange(T, dtype=torch.int32, device=x.device)
    abs_pos = pos - ((slot - slot_ids) % T)
    valid = abs_pos >= 0
    if cfg.sliding_window is not None:
        valid &= pos - abs_pos < cfg.sliding_window
    if cfg.attn_chunk is not None:
        valid &= (abs_pos // cfg.attn_chunk) == (pos // cfg.attn_chunk)
    out = _sdpa(q, cache.k, cache.v, valid[None, :])
    new_cache = KVCache(k=cache.k, v=cache.v, length=pos + 1)
    return _out_proj(out, p["wo"]), new_cache
