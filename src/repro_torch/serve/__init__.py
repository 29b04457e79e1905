"""The serving lane: the paper's DLB loop applied to MoE inference
(counterpart of ``repro.serve``).

:class:`TrafficGenerator` produces seeded drifting traffic,
:class:`ExpertRuntime` runs the in-situ measure → EWMA → knapsack →
gated-adoption loop with experts as the balancer's slots and an expert
permutation (``repro_torch.models.moe.apply_expert_permutation``) as the
adoption commit.  ``repro_torch.train.servestep.RequestBalancer`` reuses
the same balancer over request buckets.
"""
from .expert_runtime import COST_SOURCES, ExpertRuntime, permutation_for_mapping
from .traffic import TrafficConfig, TrafficGenerator

__all__ = [
    "COST_SOURCES",
    "ExpertRuntime",
    "TrafficConfig",
    "TrafficGenerator",
    "permutation_for_mapping",
]
