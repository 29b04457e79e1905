"""Serve-step factories, prefill and single-token decode with KV caches,
and serving-level DLB over request buckets (counterpart of
``repro.train.servestep``).

``make_serve_step`` returns the step of the ``decode_*`` / ``long_*``
shapes: one new token given a cache holding ``seq_len`` prior context,
chosen greedily on the device.  ``make_prefill_step`` covers ``prefill_*``
shapes.

``RequestBalancer`` treats request *buckets* as work items: measured
per-bucket decode/prefill times feed the paper's LoadBalancer to assign
buckets to data-parallel replicas.  It is the bucket-level sibling of
``repro_torch.serve.ExpertRuntime`` (experts as work items); both run the
same measure → smooth → knapsack → gate loop, and
``repro_torch.serve.TrafficGenerator.bucket_costs`` produces the bucket
costs the serving tests drive it with.  Host-only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import LoadBalancer
from ..models import ModelConfig, decode_step, prefill
from ..models.common import gathered

__all__ = ["make_serve_step", "make_prefill_step", "RequestBalancer"]


def make_serve_step(cfg: ModelConfig):
    """Build the single-token decode step (greedy argmax over the real
    vocab) for the ``decode_*``/``long_*`` serving shapes: maps
    ``(params, token, state) -> (next_token, new_state)``, the token an
    int32 (B, 1) tensor on the device.  Like ``decode_step`` it consumes
    ``state`` (updated in place), and it reads nothing back to the host."""

    def serve_step(params, token, state):
        logits, new_state = decode_step(params, cfg, token, state)
        # gathered over the vocab first: DTensor's argmax over a vocab sharded
        # on two mesh axes fails
        next_token = torch.argmax(gathered(logits, -1)[..., : cfg.vocab], dim=-1).to(torch.int32)
        return next_token, new_state

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Build the prefill step for the ``prefill_*`` serving shapes: runs the
    full prompt through the model and returns the (B, V) last-position
    logits.  It fills no KV cache, as the reference's ``prefill`` does not
    (whose factory's docstring says it returns the primed caches)."""

    def prefill_step(params, batch):
        return prefill(params, cfg, batch)

    return prefill_step


class RequestBalancer:
    """The paper's DLB applied to serving: buckets of requests are 'boxes',
    measured per-bucket step time is the in-situ cost, replicas are devices."""

    def __init__(self, n_replicas: int, interval: int = 10, threshold: float = 0.10):
        self.lb = LoadBalancer(
            n_devices=n_replicas, interval=interval, improvement_threshold=threshold
        )

    def assign(self, step: int, bucket_costs: np.ndarray) -> np.ndarray:
        """Feed one round of measured per-bucket costs and return the
        (possibly re-adopted) bucket→replica mapping; between LB rounds
        and under the 10% gate the previous mapping is returned
        unchanged."""
        self.lb.ensure_mapping(len(bucket_costs))
        new = self.lb.step(step, bucket_costs)
        return self.lb.mapping if new is None else new
