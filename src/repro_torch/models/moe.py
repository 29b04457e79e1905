"""Feed-forward blocks: SwiGLU / GeLU MLPs and capacity-based top-k MoE
(counterpart of ``repro.models.moe``).

The MoE routes each token to its top-k experts with a per-sequence
capacity, reports the in-situ expert costs beside the output
(``slots_filled``: the capacity slots actually dispatched, the executed
work; ``tokens_per_expert``: routed intent, the heuristic), and
:func:`apply_expert_permutation` is the adoption step of expert DLB.

Params are plain dicts of tensors with the reference's keys.  Products
follow ``jnp``'s type promotion (``models.common.promoted``): float32
traffic against bfloat16 weights computes in float32, the weight operand
upcast at each product (no float32 copy of the weights is kept, so an
adoption permutes only the bfloat16 stacks).  The activations compose as
``jax.nn``'s do (``models.common.silu``, ``gelu_tanh``).  The top-k keeps ``jax.lax.top_k``'s order on ties (the lower
index first) through a stable descending sort.  Nothing here reads a value
back to the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import make_generator, to_device
from .common import (
    ModelConfig,
    batch_rows,
    constrain_batch,
    fsdp_gathered,
    gelu_tanh,
    init_dense,
    init_zeros,
    mm,
    param_device,
    promoted,
    silu,
    summed,
    summed_grad,
)

__all__ = [
    "init_mlp",
    "mlp",
    "init_moe",
    "moe",
    "expert_costs",
    "apply_expert_permutation",
]


def init_mlp(key: Union[int, torch.Generator], cfg: ModelConfig, d_ff: Optional[int] = None,
             *, device=None):
    """``(params, specs)`` of a dense MLP; draws from ``key`` (a generator,
    or a seed for one on ``device``; ``device="meta"`` draws nothing)."""
    gen = make_generator(key, device)
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.mlp_type == "swiglu":
        params = {
            "w_gate": init_dense(gen, (cfg.d_model, d_ff), dt),
            "w_up": init_dense(gen, (cfg.d_model, d_ff), dt),
            "w_down": init_dense(gen, (d_ff, cfg.d_model), dt),
        }
        specs = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
    else:  # gelu (whisper)
        params = {
            "w_up": init_dense(gen, (cfg.d_model, d_ff), dt),
            "b_up": init_zeros(gen, (d_ff,), dt),
            "w_down": init_dense(gen, (d_ff, cfg.d_model), dt),
            "b_down": init_zeros(gen, (cfg.d_model,), dt),
        }
        specs = {
            "w_up": ("embed", "ff"),
            "b_up": ("ff",),
            "w_down": ("ff", "embed"),
            "b_down": ("embed",),
        }
    return params, specs


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # column-parallel: each product's input gradient completed where it is made
    if cfg.mlp_type == "swiglu":
        return mm(silu(mm(summed_grad(x), p["w_gate"])) * mm(summed_grad(x), p["w_up"]), p["w_down"])
    h = gelu_tanh(mm(summed_grad(x), p["w_up"]) + p["b_up"])
    return mm(h, p["w_down"]) + p["b_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def init_moe(key: Union[int, torch.Generator], cfg: ModelConfig, *, device=None):
    """``(params, specs)`` of an MoE block: a float32 router and the
    ``(E, D, F)``/``(E, F, D)`` expert stacks in ``cfg.param_dtype``, plus a
    shared expert when ``cfg.shared_expert``.  Draws from ``key`` (a
    generator, or a seed for one on ``device``, default ``"cuda"``;
    ``device="meta"`` draws nothing)."""
    gen = make_generator(key, device)
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    params = {
        "router": init_dense(gen, (D, E), torch.float32),
        "w_gate": init_dense(gen, (E, D, F_), dt),
        "w_up": init_dense(gen, (E, D, F_), dt),
        "w_down": init_dense(gen, (E, F_, D), dt),
    }
    specs = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ff"),
        "w_up": ("experts", "embed", "ff"),
        "w_down": ("experts", "ff", "embed"),
    }
    if cfg.shared_expert:
        sp, ss = init_mlp(gen, cfg, d_ff=cfg.d_ff, device=param_device(gen))
        params["shared"] = sp
        specs["shared"] = ss
    return params, specs


def _expert_ffn(p, expert_in: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) through the per-expert SwiGLU weights."""
    h = silu(torch.bmm(*promoted(expert_in, fsdp_gathered(p["w_gate"]))))
    h = h * torch.bmm(*promoted(expert_in, fsdp_gathered(p["w_up"])))
    return torch.bmm(*promoted(h, fsdp_gathered(p["w_down"])))


def _expert_ffn_batched(p, expert_in: torch.Tensor) -> torch.Tensor:
    """(B, E, C, D) -> (B, E, C, D): each expert's rows of every sequence
    in one batched product per weight.  Tensor parallel inside the experts
    (F over the model axis), the down product's partial sums are completed
    where they are made (:func:`summed`), and so is the gradient of the up
    products' input (:func:`summed_grad`), as :func:`mlp` completes its
    own: in float32, before a reshape across the slot dims meets them."""
    B, E, C, D = expert_in.shape
    rows = summed_grad(expert_in.transpose(0, 1).reshape(E, B * C, D))
    return summed(_expert_ffn(p, rows)).reshape(E, B, C, -1).transpose(0, 1)


def moe(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Capacity-based top-k MoE.  Returns (output, stats) where stats carries
    the in-situ expert cost observations + aux loss.

    Two dispatch implementations with identical semantics:
      * ``einsum``: GShard one-hot dispatch/combine tensors (the baseline);
      * ``sort``: each (token, choice) scattered to its capacity slot,
        dispatch a gather and combine a gather (the default).

    Dispatch is per sequence: capacity C = ceil(cf·S·K/E) per sequence.
    A (token, choice) past its expert's capacity is dropped; the sort
    dispatch writes every dropped one to the spill slot ``E·C``, which is
    sliced off (a duplicate index lands nowhere else, since a token picks
    distinct experts and each kept choice owns its slot).
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(np.ceil(cfg.capacity_factor * S * K / E)))  # per-sequence capacity

    logits = mm(x.float(), p["router"])  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k as jax.lax.top_k: descending, the lower index first on a tie
    sorted_vals, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = sorted_vals[..., :K], sorted_idx[..., :K]  # (B, S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, choice) in its expert's buffer (token order)
    onehot = F.one_hot(gate_idx, E)  # (B, S, K, E) int64
    flat_oh = onehot.reshape(B, S * K, E)
    pos_in_expert = (torch.cumsum(flat_oh, dim=1) - flat_oh).reshape(B, S, K, E)
    pos = (pos_in_expert * onehot).sum(-1)  # (B, S, K)
    keep = pos < C  # capacity-dropped tokens pass through unchanged

    if cfg.moe_impl == "einsum":
        dispatch = (
            onehot.to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, C), C + 1).to(x.dtype)[..., :C][..., None, :]
        )  # (B, S, K, E, C)
        expert_in = torch.einsum("bnkec,bnd->becd", dispatch, x)
        combine = dispatch * gate_vals.to(x.dtype)[..., None, None]
        expert_out = _expert_ffn_batched(p, expert_in)  # (B, E, C, D)
        out = torch.einsum("bnkec,becd->bnd", *promoted(combine, expert_out))
    else:
        slot = torch.where(keep, gate_idx * C + pos, E * C)  # (B, S, K); E*C = spill

        # dispatch and combine are gathers within each sequence, run on the
        # local blocks of a DTensor (torch 2.11 plans neither over a batch
        # split by two mesh axes, nor the combine's backward)
        def gather_slots(x, slot):
            b = x.shape[0]
            # each (token, choice) writes its token index + 1 (0 = empty slot)
            token = torch.arange(1, S + 1, device=x.device)[:, None].expand(S, K).reshape(S * K)
            token_of_slot = slot.new_zeros((b, E * C + 1), dtype=torch.int64)
            token_of_slot.scatter_(1, slot.reshape(b, S * K), token.expand(b, S * K))
            token_of_slot = token_of_slot[:, : E * C]
            rows = torch.arange(b, device=x.device)
            return x[rows[:, None], (token_of_slot - 1).clamp_min(0)], token_of_slot > 0  # (B, E*C, D)

        def gather_choices(expert_out, slot):
            b = expert_out.shape[0]
            padded = torch.cat([expert_out, expert_out.new_zeros(b, 1, D)], dim=1)
            rows = torch.arange(b, device=expert_out.device)
            return padded[rows[:, None, None], slot]  # (B, S, K, D); spill reads zeros

        slot_rows, filled = batch_rows(gather_slots, x, slot)
        # the slots pinned to the batch axes around the expert reshapes, their
        # gradients too (DTensor would split and merge the slot dims across a
        # model-axis shard: strided shardings it plans by graph search)
        expert_in = constrain_batch(torch.where(filled[..., None], slot_rows, 0.0).reshape(B, E, C, D))
        expert_out = constrain_batch(constrain_batch(_expert_ffn_batched(p, expert_in)).reshape(B, E * C, D))
        per_choice = batch_rows(gather_choices, expert_out, slot)
        # the reference's einsum over the K choices, accumulated as a
        # contraction accumulates: in at least float32, each choice added
        # with one fused multiply-add, one rounding to x's dtype at the end
        acc = torch.promote_types(x.dtype, torch.float32)
        w = torch.where(keep, gate_vals, 0.0).to(x.dtype).to(acc)
        per_choice = per_choice.to(acc)
        out = w[..., 0, None] * per_choice[..., 0, :]
        for k in range(1, K):
            out = torch.addcmul(out, w[..., k, None], per_choice[..., k, :])
        out = out.to(x.dtype)

    if cfg.shared_expert:
        out = out + mlp(p["shared"], cfg, x.reshape(B * S, D)).reshape(B, S, D)
    out = out.reshape(B, S, D)

    # --- in-situ cost observations (paper §2.2 analogues) ---
    tokens_per_expert = onehot.sum((0, 1, 2)).float()  # heuristic
    # work counter: slots actually dispatched (capacity-clipped = executed)
    slots_filled = (onehot * keep[..., None]).sum((0, 1, 2)).float()
    # Switch aux loss: E * sum_e f_e · P_e
    f = tokens_per_expert / tokens_per_expert.sum().clamp_min(1.0)
    pbar = probs.mean((0, 1))
    aux_loss = E * torch.sum(f * pbar)
    stats = {
        "tokens_per_expert": tokens_per_expert,
        "slots_filled": slots_filled,
        "aux_loss": aux_loss,
        "dropped_fraction": 1.0 - slots_filled.sum() / tokens_per_expert.sum().clamp_min(1.0),
    }
    return out, stats


# ---------------------------------------------------------------------------
# DLB for expert parallelism (the paper's technique applied to MoE)
# ---------------------------------------------------------------------------


def expert_costs(stats: Dict[str, torch.Tensor], strategy: str = "work_counter") -> np.ndarray:
    """Per-expert cost vector for the LoadBalancer (reads it to the host)."""
    key = {"heuristic": "tokens_per_expert", "work_counter": "slots_filled"}[strategy]
    return np.asarray(stats[key].detach().cpu().numpy(), dtype=np.float64)


def apply_expert_permutation(p: Dict, perm: np.ndarray) -> Dict:
    """Reorder the expert-stacked weights (and router columns) so expert i
    moves to position perm[i], the redistribution step of expert DLB.  The
    index reaches the device through pinned memory without a host
    synchronisation."""
    inv = to_device(np.argsort(perm).astype(np.int64), p["router"].device)
    out = dict(p)
    out["router"] = p["router"].index_select(1, inv)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = p[k].index_select(0, inv)
    return out
