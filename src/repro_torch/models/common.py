"""Shared model building blocks: config, init, norms, RoPE (counterpart of
``repro.models.common``).

Models are plain nested dicts of tensors and pure functions, with the
reference's keys, so a reference params tree converts leaf for leaf
(``repro_torch.convert.params_from``).  ``ModelConfig`` keeps the
reference's fields; its ``param_dtype`` is a ``torch.dtype``.
``ModelConfig.n_params`` and ``init_params_shapes`` call the transformer's
``init_params`` and come with the LM models.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "constrain_batch",
    "init_dense",
    "rmsnorm",
    "apply_rope",
    "rope_freqs",
    "sinusoidal_positions",
]


@dataclass(frozen=True)
class ModelConfig:
    """One config covers the whole assigned-architecture pool; unused fields
    are zero/None for a given family."""

    name: str
    kind: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA / local-attention window
    attn_chunk: Optional[int] = None  # llama4-style chunked attention
    mlp_type: str = "swiglu"  # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    expert_sharding: str = "tp"  # tp: TP inside experts | ep: experts over model axis
    moe_impl: str = "sort"  # sort: gather/scatter dispatch | einsum: GShard one-hot (baseline)
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: Tuple[str, ...] = ("a",)  # 'a' attention | 'r' RG-LRU | 's' SSD
    rglru_width: int = 0  # recurrent branch width (0 -> d_model)
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frontend frames (stub)
    # --- VLM (qwen2-vl) ---
    n_patches: int = 0  # early-fusion patch embeddings (stub)
    # --- numerics ---
    norm_eps: float = 1e-6
    param_dtype: Any = torch.bfloat16
    vocab_pad_to: int = 256  # pad embedding tables for TP divisibility
    # --- notes for DESIGN/dry-run bookkeeping ---
    sub_quadratic: bool = False  # can run long_500k
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab padded for tensor-parallel divisibility
        (padded logits are masked out of the loss)."""
        if self.vocab_pad_to <= 1:
            return self.vocab
        return int(-(-self.vocab // self.vocab_pad_to) * self.vocab_pad_to)

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# A parameter's logical axes (a parallel tree of axis tuples made at init).
ParamSpec = Tuple[str, ...]


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """The identity: the reference pins the batch dim to the data-parallel
    mesh axes; a single controller over logical devices has no sharding
    constraint to set."""
    return x


def init_dense(
    gen: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in)),
    drawn in float32 from ``gen`` on the generator's device, then cast.
    The draws are not the reference's (the JAX PRNG is not reproduced);
    the distribution is."""
    if scale is None:
        scale = 1.0 / np.sqrt(shape[0])
    # inverse CDF: u uniform on [Phi(-2), Phi(2)] -> sqrt(2)·erfinv(2u - 1)
    lo, hi = _norm_cdf(-2.0), _norm_cdf(2.0)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    t.erfinv_().mul_(float(np.sqrt(2.0))).clamp_(-2.0, 2.0)
    return (t * scale).to(dtype)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32).to(x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int) -> np.ndarray:
    """Whisper-style sinusoidal position embeddings (length-agnostic)."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / (10_000 ** (dim / d_model))
    out = np.zeros((seq, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out
