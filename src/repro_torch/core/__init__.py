"""Cost measurement, distribution-mapping policies, the gated load balancer
and the virtual-cluster walltime model (paper §2.2, Eq. 1).

numpy-only copies of ``repro.core``'s modules: the port keeps its own so it
imports nothing of the JAX package.  ``perfmodel`` is not ported yet.
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
