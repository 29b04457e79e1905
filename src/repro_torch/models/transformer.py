"""Model assembly for the assigned-architecture pool (counterpart of
``repro.models.transformer``).

One code path covers all ten architectures through ``ModelConfig``:
  * dense / MoE decoder-only LMs (qwen3, yi, phi3, qwen2.5, mixtral,
    llama4-scout, qwen2-vl),
  * attention-free SSM (mamba2),
  * hybrid RG-LRU + local attention (recurrentgemma),
  * encoder-decoder (whisper; conv frontend stubbed to frame embeddings).

The params keep the reference's **stacked** layout: ``blocks[f"{kind}{j}"]``
leaves (and ``enc_blocks``/``dec_blocks``) carry a leading layers axis,
heterogeneous stacks (recurrentgemma's r,r,a pattern) stack *groups*, and a
remainder partial group lives unstacked in ``tail_blocks``.  So a reference
params tree converts leaf for leaf (``repro_torch.convert.params_from``).
The reference's ``lax.scan`` over groups becomes a host loop over the group
index on per-layer views of each leaf.  Its per-layer remat
(``jax.checkpoint`` of the scan body) is carried over: while autograd
records, each group runs under ``torch.utils.checkpoint`` (non-reentrant),
so the backward keeps one (B, S, D) boundary activation per group and
recomputes the group's interior; the remainder blocks run without it, as
in the reference.  Under ``torch.no_grad`` (prefill, decode) nothing
changes.  ``loss_fn`` is the training loss on ``forward_train``.

``decode_step`` updates the decode state **in place** (the KV caches at a
device index, the recurrent states by copy into their stacked slices) and
returns a ``DecodeState`` with ``position + 1``: it consumes its input
state.  Nothing on the decode path reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .._device import make_generator, map_tensors, resolve_device
from .attention import NEG_INF, attention, decode_attention, init_attention, init_kv_cache
from .common import (
    ModelConfig,
    constrain_batch,
    embed_rows,
    init_dense,
    init_zeros,
    local_block,
    mm,
    param_device,
    rmsnorm,
    sinusoidal_rows,
    summed,
    summed_grad,
)
from .moe import init_mlp, init_moe, mlp, moe
from .rglru import init_rglru_block, init_rglru_state, rglru_decode_step, rglru_forward
from .ssm import init_ssd, init_ssd_state, ssd_decode_step, ssd_forward

__all__ = [
    "init_params",
    "forward_train",
    "prefill",
    "decode_step",
    "init_decode_state",
    "DecodeState",
    "loss_fn",
]


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------


def _init_block(gen, cfg: ModelConfig, kind: str, cross: bool = False):
    dt = cfg.param_dtype
    D = cfg.d_model
    dev = param_device(gen)
    if kind == "a":
        p_attn, s_attn = init_attention(gen, cfg, device=dev)
        if cfg.n_experts > 0:
            p_ff, s_ff = init_moe(gen, cfg, device=dev)
        else:
            p_ff, s_ff = init_mlp(gen, cfg, device=dev)
        params = {"ln1": init_zeros(gen, (D,), dt), "attn": p_attn,
                  "ln2": init_zeros(gen, (D,), dt), "ff": p_ff}
        specs = {"ln1": ("embed",), "attn": s_attn, "ln2": ("embed",), "ff": s_ff}
        if cross:
            p_x, s_x = init_attention(gen, cfg, cross=True, device=dev)
            params["ln_x"] = init_zeros(gen, (D,), dt)
            params["xattn"] = p_x
            specs["ln_x"] = ("embed",)
            specs["xattn"] = s_x
        return params, specs
    if kind == "r":
        p_rec, s_rec = init_rglru_block(gen, cfg, device=dev)
        p_ff, s_ff = init_mlp(gen, cfg, device=dev)
        return (
            {"ln1": init_zeros(gen, (D,), dt), "rec": p_rec, "ln2": init_zeros(gen, (D,), dt),
             "ff": p_ff},
            {"ln1": ("embed",), "rec": s_rec, "ln2": ("embed",), "ff": s_ff},
        )
    if kind == "s":
        p_ssd, s_ssd = init_ssd(gen, cfg, device=dev)
        return (
            {"ln1": init_zeros(gen, (D,), dt), "ssd": p_ssd},
            {"ln1": ("embed",), "ssd": s_ssd},
        )
    raise ValueError(f"unknown block kind {kind!r}")


def _pattern_groups(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    pat = cfg.block_pattern
    return cfg.n_layers // len(pat), tuple(pat[: cfg.n_layers % len(pat)])


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _copy_layer(dst, src, i: int) -> None:
    """Write one layer's tree into row ``i`` of the stacked tree ``dst``."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_layer(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def _stack_init(gen, cfg: ModelConfig, kinds, n: int, cross: bool = False):
    """``n`` group-param trees stacked on a leading axis.  Each layer is
    drawn on the generator's device and written into a preallocated stack,
    so the float32 draw of one layer's leaf is the only temporary."""
    stacked = None
    for i in range(n):
        layer = {f"{kind}{j}": _init_block(gen, cfg, kind, cross=cross)[0]
                 for j, kind in enumerate(kinds)}
        if stacked is None:
            stacked = map_tensors(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
        _copy_layer(stacked, layer, i)
        del layer
    specs = {
        f"{kind}{j}": _map_specs(lambda ax: ("layers",) + ax, _init_block(None, cfg, kind, cross)[1])
        for j, kind in enumerate(kinds)
    }
    return stacked, specs


def init_params(key, cfg: ModelConfig, *, device=None):
    """Returns (params, specs).  Stacked block params have a leading 'layers'
    axis.  Draws from ``key`` (a generator, or a seed for one on ``device``,
    default ``"cuda"``); ``device="meta"`` builds the tree of shapes and
    dtypes with no allocation and no draw.  The draws are not the
    reference's; the tree, the shapes and the distributions are."""
    gen = make_generator(key, device)
    n_groups, remainder = _pattern_groups(cfg)
    dt = cfg.param_dtype
    D = cfg.d_model
    V = cfg.vocab_padded  # padded for TP divisibility; loss masks the padding
    params: Dict[str, Any] = {"embed": init_dense(gen, (V, D), dt, scale=1.0)}
    specs: Dict[str, Any] = {"embed": ("vocab", "embed")}

    if cfg.kind == "encdec":
        enc_stack, enc_specs = _stack_init(gen, cfg, ("a",), cfg.n_enc_layers)
        dec_stack, dec_specs = _stack_init(gen, cfg, ("a",), cfg.n_layers, cross=True)
        params.update(enc_blocks=enc_stack, dec_blocks=dec_stack)
        specs.update(enc_blocks=enc_specs, dec_blocks=dec_specs)
        params["enc_norm"] = init_zeros(gen, (D,), dt)
        specs["enc_norm"] = ("embed",)
    else:
        blocks, block_specs = _stack_init(gen, cfg, cfg.block_pattern, n_groups)
        params["blocks"] = blocks
        specs["blocks"] = block_specs
        if remainder:
            rem, rem_specs = {}, {}
            for j, kind in enumerate(remainder):
                rem[f"{kind}{j}"], rem_specs[f"{kind}{j}"] = _init_block(gen, cfg, kind)
            params["tail_blocks"] = rem
            specs["tail_blocks"] = rem_specs

    params["final_norm"] = init_zeros(gen, (D,), dt)
    specs["final_norm"] = ("embed",)
    params["lm_head"] = init_dense(gen, (D, V), dt)
    specs["lm_head"] = ("embed", "vocab")
    if cfg.n_patches > 0:  # VLM early-fusion projection for patch stubs
        params["patch_proj"] = init_dense(gen, (D, D), dt)
        specs["patch_proj"] = ("embed", "embed2")
    return params, specs


def _unstack(tree) -> List[Any]:
    """The per-layer trees of a stacked tree: views along the leading axis
    of every leaf (nested dicts and NamedTuples), no copies."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_unstack(v) for v in tree]
        return [type(tree)(*(p[i] for p in parts)) for i in range(len(parts[0]))]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# training / prefill forward
# ---------------------------------------------------------------------------

_STAT_KEYS = ("aux_loss", "tokens_per_expert", "slots_filled")


def _apply_block(bp, cfg: ModelConfig, kind: str, x, positions, *, causal=True, use_rope=True,
                 enc_out=None, stats_acc=None):
    if kind == "a":
        x = x + attention(bp["attn"], cfg, rmsnorm(x, bp["ln1"], cfg.norm_eps), positions,
                          causal=causal, use_rope=use_rope)
        if enc_out is not None:
            x = x + attention(bp["xattn"], cfg, rmsnorm(x, bp["ln_x"], cfg.norm_eps), positions,
                              x_kv=enc_out, use_rope=False)
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if cfg.n_experts > 0:
            out, stats = moe(bp["ff"], cfg, h)
            if stats_acc is not None:
                for key in _STAT_KEYS:
                    stats_acc[key] = stats_acc[key] + stats[key]
            x = x + out
        else:
            x = x + mlp(bp["ff"], cfg, h)
    elif kind == "r":
        x = x + rglru_forward(bp["rec"], cfg, rmsnorm(x, bp["ln1"], cfg.norm_eps))
        x = x + mlp(bp["ff"], cfg, rmsnorm(x, bp["ln2"], cfg.norm_eps))
    elif kind == "s":
        x = x + ssd_forward(bp["ssd"], cfg, rmsnorm(x, bp["ln1"], cfg.norm_eps))
    return x


def _run_stack(stacked, cfg: ModelConfig, kinds, x, positions, *, causal=True,
               use_rope=True, enc_out=None):
    """A host loop over the stacked groups; accumulates MoE stats.  While
    autograd records, each group is checkpointed (per-layer remat)."""
    E = cfg.n_experts
    stats = {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device),
        "tokens_per_expert": torch.zeros((E,), dtype=torch.float32, device=x.device),
        "slots_filled": torch.zeros((E,), dtype=torch.float32, device=x.device),
    } if E > 0 else {}

    def body(x, stats, gp):
        x = constrain_batch(x)
        acc = dict(stats) if stats else None
        for j, kind in enumerate(kinds):
            x = _apply_block(gp[f"{kind}{j}"], cfg, kind, x, positions, causal=causal,
                             use_rope=use_rope, enc_out=enc_out, stats_acc=acc)
        return x, (acc if acc is not None else stats)

    for gp in _unstack(stacked):
        if torch.is_grad_enabled():
            x, stats = checkpoint(body, x, stats, gp, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, stats = body(x, stats, gp)
    return x, stats


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    tokens = batch["tokens"]
    x = constrain_batch(embed_rows(params["embed"], tokens).to(cfg.param_dtype))
    if cfg.n_patches > 0 and "patch_embeds" in batch:
        pe = mm(batch["patch_embeds"].to(cfg.param_dtype), params["patch_proj"])
        n_p = pe.shape[1]
        x = torch.cat([pe, x[:, n_p:]], dim=1)  # early fusion
    return x


def forward_train(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  return_hidden: bool = False):
    """Teacher-forced forward.  Returns (logits, aux_stats) — or the
    pre-final-norm hidden states when ``return_hidden`` (prefill path).
    Runs on the device of ``batch["tokens"]``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    if cfg.kind == "encdec":
        audio = batch["audio_embed"].to(cfg.param_dtype)
        enc_rows = torch.arange(audio.shape[1], device=dev)
        enc_x = audio + sinusoidal_rows(enc_rows, cfg.d_model).to(cfg.param_dtype)
        enc_x, _ = _run_stack(params["enc_blocks"], cfg, ("a",), enc_x, positions,
                              causal=False, use_rope=False)
        enc_out = rmsnorm(enc_x, params["enc_norm"], cfg.norm_eps)
        dec_pos = sinusoidal_rows(torch.arange(S, device=dev), cfg.d_model).to(cfg.param_dtype)
        x = embed_rows(params["embed"], tokens).to(cfg.param_dtype) + dec_pos
        x, stats = _run_stack(params["dec_blocks"], cfg, ("a",), x, positions,
                              causal=True, use_rope=False, enc_out=enc_out)
    else:
        x = _embed_inputs(params, cfg, batch)
        x, stats = _run_stack(params["blocks"], cfg, cfg.block_pattern, x, positions)
        if "tail_blocks" in params:
            _, remainder = _pattern_groups(cfg)
            for j, kind in enumerate(remainder):
                x = _apply_block(params["tail_blocks"][f"{kind}{j}"], cfg, kind, x, positions)
    if return_hidden:
        return x, stats
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = mm(summed_grad(x), params["lm_head"])
    return logits, stats


class _GoldLogit(torch.autograd.Function):
    """``torch.gather(logits, -1, index)`` for an (..., 1) index, with
    autograd's own backward (the gradient added into zeros like ``logits``
    at the index), written so that DTensor can run it.  On a vocab-sharded
    DTensor the gathered values are partial sums (completed before the
    caller's select, which DTensor's masked partial cannot follow), and
    autograd's backward would make its zeros replicated at the logits' global
    shape: here each chip adds into its own vocab block the gradients whose
    index falls in it."""

    @staticmethod
    def forward(ctx, logits, index):
        ctx.save_for_backward(logits, index)
        return summed(torch.gather(logits, -1, index))

    @staticmethod
    def backward(ctx, grad):
        logits, index = ctx.saved_tensors
        out = torch.zeros_like(logits)
        if not isinstance(out, DTensor):
            return out.scatter_add_(-1, index, grad), None
        block, first, (index, grad) = local_block(out, -1, index, grad)
        local = index - first
        mine = (local >= 0) & (local < block.shape[-1])
        block.scatter_add_(-1, local.clamp(0, block.shape[-1] - 1), torch.where(mine, grad, 0.0))
        return out, None


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], aux_weight: float = 0.01):
    """Mean token cross-entropy over ``labels >= 0`` (float32, the padded
    vocab columns masked out), plus ``aux_weight`` times the MoE aux loss.
    Returns (loss, metrics) with the reference's metric keys."""
    logits, stats = forward_train(params, cfg, batch)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab:  # mask padded vocab columns
        pad_mask = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = torch.where(pad_mask, NEG_INF, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = _GoldLogit.apply(logits, labels.clamp(min=0).long().unsqueeze(-1))[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    metrics = {"ce_loss": loss, "n_tokens": mask.sum()}
    if stats:
        loss = loss + aux_weight * stats["aux_loss"]
        metrics.update(
            moe_aux_loss=stats["aux_loss"],
            tokens_per_expert=stats["tokens_per_expert"],
            slots_filled=stats["slots_filled"],
        )
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (serving) path
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: Any  # dict of stacked per-group block states
    tail: Any  # states for remainder blocks (or None)
    enc_out: Optional[torch.Tensor]  # encoder output (encdec only)
    position: torch.Tensor  # 0-d int32 on the device


def _init_block_state(cfg: ModelConfig, kind: str, batch: int, seq_len: int, cross: bool,
                      filled: bool, device):
    if kind == "a":
        st = {"kv": init_kv_cache(cfg, batch, seq_len, filled=filled, device=device)}
        if cross:
            # cross K/V are computed from enc_out at prefill; store here
            shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
            st["xk"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
            st["xv"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        return st
    if kind == "r":
        return {"rg": init_rglru_state(cfg, batch, device=device)}
    if kind == "s":
        return {"ssd": init_ssd_state(cfg, batch, device=device)}
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, filled: bool = True,
                      *, device=None) -> DecodeState:
    """Decode state with caches sized for `seq_len` context.  ``filled=True``
    builds the decode-benchmark state (caches holding seq_len prior tokens);
    ``filled=False`` starts generation from scratch.  Built on ``device``
    (default ``"cuda"``; ``"meta"`` allocates nothing)."""
    dev = resolve_device(device)
    n_groups, remainder = _pattern_groups(cfg)
    cross = cfg.kind == "encdec"
    kinds = ("a",) if cross else cfg.block_pattern
    n = cfg.n_layers if cross else n_groups

    one = {
        f"{kind}{j}": _init_block_state(cfg, kind, batch, seq_len, cross, filled, dev)
        for j, kind in enumerate(kinds)
    }
    caches = map_tensors(lambda t: t.unsqueeze(0).expand(n, *t.shape).clone(), one)
    tail = (
        {
            f"{kind}{j}": _init_block_state(cfg, kind, batch, seq_len, False, filled, dev)
            for j, kind in enumerate(remainder)
        }
        if (remainder and not cross)
        else None
    )
    enc_out = (
        torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=cfg.param_dtype, device=dev)
        if cross else None
    )
    return DecodeState(
        caches=caches,
        tail=tail,
        enc_out=enc_out,
        position=torch.full((), seq_len if filled else 0, dtype=torch.int32, device=dev),
    )


def _decode_block(bp, cfg: ModelConfig, kind: str, x, st, cross: bool):
    new_st = dict(st)
    if kind == "a":
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        out, new_kv = decode_attention(bp["attn"], cfg, h, st["kv"])
        x = x + out
        if cross:
            hx = rmsnorm(x, bp["ln_x"], cfg.norm_eps)
            out_x, _ = decode_attention(
                bp["xattn"], cfg, hx, st["kv"], cross_kv=(st["xk"], st["xv"])
            )
            x = x + out_x
        h2 = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if cfg.n_experts > 0:
            out2, _ = moe(bp["ff"], cfg, h2)
            x = x + out2
        else:
            x = x + mlp(bp["ff"], cfg, h2)
        new_st["kv"] = new_kv
    elif kind == "r":
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        out, new_rg = rglru_decode_step(bp["rec"], cfg, h, st["rg"])
        x = x + out
        x = x + mlp(bp["ff"], cfg, rmsnorm(x, bp["ln2"], cfg.norm_eps))
        new_st["rg"] = new_rg
    elif kind == "s":
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        out, new_ssd = ssd_decode_step(bp["ssd"], cfg, h, st["ssd"])
        x = x + out
        new_st["ssd"] = new_ssd
    return x, new_st


def _write_back(st, new_st) -> None:
    """Copy a block's new recurrent state into its stacked slice ``st``.
    The KV caches were written in place; their lengths advance once per
    stack (``decode_step``)."""
    for key in ("rg", "ssd"):
        if key in new_st:
            for old, new in zip(st[key], new_st[key]):
                old.copy_(new)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, state: DecodeState):
    """One serving step: next-token logits (B, 1, V) for `token` (B, 1)
    given caches.  Consumes ``state``: its caches are updated in place and
    returned in a ``DecodeState`` with ``position + 1`` (clone a state
    before decoding from it if it is needed again)."""
    cross = cfg.kind == "encdec"
    kinds = ("a",) if cross else cfg.block_pattern
    # pinned to the batch axes as the reference's partitioner moves the
    # lookup's columns to the batch rows (an all-to-all) before the first
    # block: left on its columns, every product of the step would be split
    # over the contraction and all-reduced over the data axis
    x = constrain_batch(embed_rows(params["embed"], token).to(cfg.param_dtype))
    if cross:
        cap = state.caches["a0"]["kv"].k.shape[2]  # (n_layers, B, T, K, hd)
        row = torch.clamp(state.position, max=cap)  # the reference's table has cap + 1 rows
        x = x + sinusoidal_rows(row, cfg.d_model).to(cfg.param_dtype)

    stacked = params["dec_blocks"] if cross else params["blocks"]
    for gp, st in zip(_unstack(stacked), _unstack(state.caches)):
        for j, kind in enumerate(kinds):
            name = f"{kind}{j}"
            x, new_st = _decode_block(gp[name], cfg, kind, x, st[name], cross)
            _write_back(st[name], new_st)
    new_caches = {
        name: (dict(c, kv=c["kv"]._replace(length=c["kv"].length + 1)) if "kv" in c else c)
        for name, c in state.caches.items()
    }

    new_tail = state.tail
    if state.tail is not None:
        _, remainder = _pattern_groups(cfg)
        new_tail = {}
        for j, kind in enumerate(remainder):
            x, new_tail[f"{kind}{j}"] = _decode_block(
                params["tail_blocks"][f"{kind}{j}"], cfg, kind, x, state.tail[f"{kind}{j}"], False
            )

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = mm(x, params["lm_head"])
    new_state = DecodeState(
        caches=new_caches, tail=new_tail, enc_out=state.enc_out, position=state.position + 1
    )
    return logits, new_state


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Prefill benchmark path: full-sequence forward; the LM head runs on the
    last position only (the slice is taken *before* the head).  Returns the
    (B, V) last-position logits and fills no cache, as the reference's."""
    hidden, _ = forward_train(params, cfg, batch, return_hidden=True)
    last = rmsnorm(hidden[:, -1], params["final_norm"], cfg.norm_eps)
    return mm(last, params["lm_head"])
