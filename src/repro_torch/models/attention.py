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

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial

from .._device import make_generator, resolve_device
from .common import (
    ModelConfig,
    apply_rope,
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


def _sdpa(q, k, v, mask):
    """q: (B,S,H,hd)  k/v: (B,T,K,hd)  mask: (S,T) or (B,S,T).  GQA grouped."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    if K == 1 and isinstance(k, DTensor) and not any(p.is_shard(d) for p in k.placements for d in (1, 2, 3)):
        heads = model_block(q, 2)
        if heads.placements != q.placements:
            return _mqa_local(heads, k, v, mask)
    q = even_heads(q, 2, K).reshape(B, S, K, G, hd)
    scores = einsum("bskgh,btkh->bkgst", q, k).float()
    # jnp.sqrt(hd) is a float32 sqrt; a float64 sqrt rounds to the same float32
    scores = scores / float(np.float32(np.sqrt(hd)))
    if mask.ndim == 2:
        mask_b = mask[None, None, None]
    else:
        mask_b = mask[:, None, None]
    scores = torch.where(mask_b, scores, NEG_INF)
    probs = _softmax(scores).to(v.dtype)
    out = einsum("bkgst,btkh->bskgh", probs, v)
    return whole_grad(out.reshape(B, S, H, hd), 2)


def _mqa_local(q: DTensor, k: DTensor, v: DTensor, mask) -> DTensor:
    """Multi-query attention (one KV head, whole on every chip) on each
    chip's block of the query heads, as the reference's partitioner runs
    it: :func:`_sdpa` on the local blocks, ``q`` 's heads split over the
    model axis (:func:`common.model_block`), and the KV's gradients, each
    chip's heads' share, all-reduced where they are made
    (:func:`common.summed_grad`).  On local blocks because torch 2.11's
    DTensor cannot flatten the product's batch dims with the heads split
    inside them.  Returns (B, S, H, hd) laid out as ``q``."""
    grad = [Partial() if p.is_shard(2) else p for p in q.placements]
    out = _sdpa(q.to_local(), summed_grad(k).to_local(grad_placements=grad),
                summed_grad(v).to_local(grad_placements=grad), mask)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False, shape=q.shape, stride=q.stride())


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
