"""The sharded production runtime and what it is built from (counterpart of
``repro.dist``; ``pipeline="sync"``, ``overlap=False``).

``ShardedRuntime`` steps box slots over a ring of logical devices, one
device-resident loop and one history fetch per LB interval, with the
neighbour or ring collectives of ``collectives`` between the phases.
``BoxRuntime``, ``elastic``, ``faults``, ``recovery`` and ``sharding`` are
not ported yet (ROADMAP queue 1).
"""
from .collectives import neighbor_exchange, neighbor_reduce, ring_all_gather
from .runtime_api import (
    ENGINE_BACKENDS,
    PIPELINES,
    BalancedRuntime,
    DistributedPICRuntime,
    StragglerLoop,
    device_work,
    restore_balancer,
    snapshot_balancer,
    validate_engine_backend,
    validate_pipeline,
)
from .sharded_runtime import ShardedRuntime
from .straggler import StragglerDetector

__all__ = [
    "ShardedRuntime",
    "StragglerDetector",
    "StragglerLoop",
    "BalancedRuntime",
    "DistributedPICRuntime",
    "device_work",
    "snapshot_balancer",
    "restore_balancer",
    "validate_pipeline",
    "validate_engine_backend",
    "PIPELINES",
    "ENGINE_BACKENDS",
    "ring_all_gather",
    "neighbor_exchange",
    "neighbor_reduce",
]
