"""Deterministic synthetic LM data pipeline (counterpart of
``repro.data.pipeline``).

Seeded per (run_seed, step): restartable mid-run (after a checkpoint
restore the pipeline regenerates exactly the batches the restored step
expects) and cheap (no IO).  Stands in for a tokenized corpus reader; the
interface (``batch_at(step)``) is what a real loader would implement with
deterministic shard assignment.

The draws are the reference's, made with numpy in the same order, so the
batches are the reference's bit for bit (the bfloat16 embeddings are the
same float32 normals rounded to nearest even on the device).  The
reference's ``sharding`` argument becomes ``device``: the batch is put on
one device (default ``"cuda"``) through pinned memory, without a host
synchronisation.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..models import ModelConfig

__all__ = ["SyntheticLMData"]


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0, *, device=None):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch for a given step — pure function of (seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        cfg = self.cfg
        # Markov-ish structured tokens so the CE loss is learnable, not pure noise
        base = rng.integers(0, cfg.vocab, (self.batch, self.seq_len), dtype=np.int32)
        repeat_mask = rng.random((self.batch, self.seq_len)) < 0.5
        tokens = np.where(repeat_mask, np.roll(base, 1, axis=1), base)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1  # no target for the last position
        out = {"tokens": to_device(tokens, self.device), "labels": to_device(labels, self.device)}
        if cfg.kind == "encdec":
            out["audio_embed"] = self._bf16(rng.normal(0, 1, (self.batch, cfg.enc_seq, cfg.d_model)))
        if cfg.n_patches > 0:
            out["patch_embeds"] = self._bf16(rng.normal(0, 1, (self.batch, cfg.n_patches, cfg.d_model)))
        return out

    def _bf16(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a.astype(np.float32), self.device).to(torch.bfloat16)
