"""The sharded production runtime and what it is built from (counterpart of
``repro.dist``; both pipelines, ``overlap=False``).

``ShardedRuntime`` steps box slots over a ring of logical devices, one
device-resident loop and one history fetch per LB interval, with the
neighbour or ring collectives of ``collectives`` between the phases.
``recovery.RecoveryRunner`` makes it crash-safe with checkpoints
(``repro_torch.ckpt``), seeded faults (``faults``) and the elastic device
set (``elastic``).  ``BoxRuntime`` and ``sharding`` are not ported yet
(ROADMAP queue 1).
"""
from .collectives import neighbor_exchange, neighbor_reduce, ring_all_gather
from .elastic import DeviceSet, ElasticRunner
from .faults import (
    CorruptState,
    DeviceLoss,
    Fault,
    FaultInjector,
    FaultSchedule,
    TransientFault,
)
from .recovery import RecoveryError, RecoveryRunner
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
    "DeviceSet",
    "ElasticRunner",
    "CorruptState",
    "DeviceLoss",
    "Fault",
    "FaultInjector",
    "FaultSchedule",
    "RecoveryError",
    "RecoveryRunner",
    "TransientFault",
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
