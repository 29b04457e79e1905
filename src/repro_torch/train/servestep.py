"""Serving-level DLB over request buckets (counterpart of
``repro.train.servestep``; the prefill and decode step factories come
with the LM models).

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

from ..core import LoadBalancer

__all__ = ["RequestBalancer"]


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
