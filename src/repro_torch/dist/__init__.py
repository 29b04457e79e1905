"""The distributed PIC runtimes and what they are built from (counterpart
of ``repro.dist``).

``ShardedRuntime`` steps box slots over a ring of logical devices, one
device-resident loop and one history fetch per LB interval, with the
neighbour or ring collectives of ``collectives`` between the phases (both
pipelines; ``overlap=True`` splits each step around the current fold).
``BoxRuntime`` is the host-driven validation runtime: one dispatch per box
per step, each box's state on its own logical device.
``recovery.RecoveryRunner`` makes either crash-safe with checkpoints
(``repro_torch.ckpt``), seeded faults (``faults``) and the elastic device
set (``elastic``).  ``sharding`` serves only the LM stack and is not ported
yet (ROADMAP queue 1, slice C).
"""
from .box_runtime import BoxRuntime
from .collectives import (
    NeighborExchangeHandle,
    neighbor_exchange,
    neighbor_exchange_done,
    neighbor_exchange_start,
    neighbor_reduce,
    ring_all_gather,
)
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
from .sharded_runtime import ShardedRuntime, split_phase_order
from .straggler import StragglerDetector

__all__ = [
    "BoxRuntime",
    "ShardedRuntime",
    "split_phase_order",
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
    "NeighborExchangeHandle",
    "neighbor_exchange_start",
    "neighbor_exchange_done",
]
