"""Cost measurement, distribution-mapping policies, the gated load balancer
and the virtual-cluster walltime model (paper §2.2, Eq. 1), and the strong-scaling model that turns an initial
efficiency into a predicted maximum speedup (paper §4, Eq. 2).

numpy-only copies of ``repro.core``'s modules: the port keeps its own so it
imports nothing of the JAX package.
"""
from .costs import (
    ActivityLedger,
    ActivityLedgerCost,
    ActivityRecord,
    CostMeasure,
    EMASmoother,
    HeuristicCost,
    WorkCounterCost,
    normalize_costs,
)
from .balancer import LBEvent, LoadBalancer, efficiency, make_policy
from .perfmodel import (
    StrongScalingModel,
    fit_strong_scaling,
    fraction_of_predicted,
    imbalance_summary,
    predicted_max_speedup,
)
from .policies import (
    device_loads,
    hop_radius,
    knapsack_partition,
    locality_repair,
    morton_index,
    round_robin_mapping,
    sfc_partition,
)
from .virtual_cluster import StepRecord, VirtualCluster

__all__ = [
    "ActivityLedger",
    "ActivityLedgerCost",
    "ActivityRecord",
    "CostMeasure",
    "EMASmoother",
    "HeuristicCost",
    "WorkCounterCost",
    "normalize_costs",
    "LBEvent",
    "LoadBalancer",
    "efficiency",
    "make_policy",
    "StrongScalingModel",
    "fit_strong_scaling",
    "predicted_max_speedup",
    "fraction_of_predicted",
    "imbalance_summary",
    "device_loads",
    "hop_radius",
    "knapsack_partition",
    "locality_repair",
    "morton_index",
    "round_robin_mapping",
    "sfc_partition",
    "StepRecord",
    "VirtualCluster",
]
