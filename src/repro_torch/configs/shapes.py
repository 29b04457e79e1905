"""Assigned input-shape set + applicability rules + input_specs()
(counterpart of ``repro.configs.shapes``).

Shapes (per assignment):
    train_4k     seq 4,096   global_batch 256   (training)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill)
    decode_32k   seq 32,768  global_batch 128   (one token, 32k KV cache)
    long_500k    seq 524,288 global_batch 1     (long-context decode)

``long_500k`` requires sub-quadratic attention: skipped for pure
full-attention archs.  ``input_specs`` returns ``meta`` tensors, the
counterpart of ``jax.ShapeDtypeStruct`` stand-ins: shapes and dtypes with
no allocation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models import ModelConfig, init_decode_state

__all__ = ["SHAPES", "ShapeSpec", "applicable", "input_specs", "decode_state_specs"]

_META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return "full quadratic attention at 524k — skipped per assignment"
    return None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _token_specs(cfg: ModelConfig, B: int, S: int, labels: bool):
    out = {"tokens": _spec((B, S), torch.int32)}
    if labels:
        out["labels"] = _spec((B, S), torch.int32)
    if cfg.kind == "encdec":
        out["audio_embed"] = _spec((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.n_patches > 0:
        out["patch_embeds"] = _spec((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
    return out


def decode_state_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """``init_decode_state`` on the ``meta`` device: allocates nothing."""
    return init_decode_state(cfg, batch, seq_len, device=_META)


def input_specs(cfg: ModelConfig, shape: str, batch_override: Optional[int] = None):
    """``meta`` stand-ins for every model input of the given shape.

    train/prefill -> {'batch': {...}}; decode -> {'token', 'state'}.
    """
    spec = SHAPES[shape]
    B = batch_override or spec.global_batch
    if spec.mode in ("train", "prefill"):
        return {"batch": _token_specs(cfg, B, spec.seq_len, labels=True)}
    return {
        "token": _spec((B, 1), torch.int32),
        "state": decode_state_specs(cfg, B, spec.seq_len),
    }
